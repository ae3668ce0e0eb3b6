#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one H100.

    python3 chip_smoke.py [--profile] [--skip-serve]

Phases, each of which must pass (any failure raises and exits nonzero),
each with its seconds logged:

  1. environment: the card's name and power limit, torch/CUDA versions, the
     sm_90 check, and the build of every CUDA kernel from the sources in
     this checkout (one nvcc per source, in parallel), with each kernel
     function's registers and spills from ptxas and the tensor-core
     instruction counts (HMMA / HGMMA) of the four libraries that run on the
     tensor cores (flash, paged prefill, the GEMM, the conv);
  2. every kernel against its plain PyTorch version on the card, with
     kernel / plain / library times and the roofline bound (and, at the
     serving shapes of the GEMM, paged decode and the two tensor-core
     attention kernels, at ResNet-18's conv groups and at dense decode's
     shape, the kernel's and the library call's device time under
     CUDA-graph replay, over the same rotating input copies): the
     serving kernels at the serving path's shapes in bf16 and at the JAX
     tests' small shapes in f32; the four split kernels (the GEMM's and the
     conv's split-K, paged and dense decode's split-KV) also at their split
     edges, each such call twice and bitwise equal; paged prefill also in
     bf16 with warps straddling
     segments, rows past the fill, idle segments, pool blocks of 8 / 32,
     D 64 / 256 and G 1-8; the GEMM also at ResNet-18's fc
     (M=1, f32, bias); the conv kernel at ResNet-18's 11 conv groups
     (f32; bf16 at two, the stem one of them), every splitting (bn,
     row_block) of its two longest-K groups in f32 and bf16, the JAX tests'
     sweep at every (bn, row_block) it takes, each activation, VALID
     padding and a ragged Cout; the elementwise kernel at
     ResNet-18's four residual shapes (device time beside an empty launch
     of the same geometry, the launch floor, and beside the two kernels
     the engine ran there before: add, then relu), at one streaming shape
     off the main path in f32 and bf16 (with its geometry swept), at
     lengths 1-17 and 2^k +- 1 with x and the extras aligned, both one
     element past a 16-byte boundary (the scalar head) and only x past it
     (the scalar body), in f32 and bf16, with [mul, add] and [mul, sub]
     bitwise equal to separate ops in f32 (no FMA contraction), and on
     chains of every op in f32 and bf16; the dense flash kernel at the serve graph's three attention
     shapes (bf16), the JAX tests' sweep and causal Sq < Skv / Sq > Skv
     (f32), ragged bf16 shapes (Sq, Skv not multiples of 16, causal and
     not) and every tile its template admits; the dense decode kernel at
     the decode stage's shape with ragged lengths (bf16), at its split
     edges (lengths 0, kps - 1 / kps / kps + 1, S and past S) in bf16 and
     in f32 at G = 1 / 4 / 8 / 16 and D = 64 / 128 / 256, and at the JAX
     tests' length sets (f32); a CUDA graph of dense decode captured before
     its split counters grow, replayed after a larger eager launch grew
     them, bitwise equal to the eager call; the keyed draw kernel at the
     decode lane's (8, 151936) and the chunk lane's (4, 151936) with bf16
     logits, rows of temperature 0, pure temperature, top-k and top-p, at
     seeds 0 / 1 / 2^31 - 1 and token indices 0 / 31: tokens equal to the
     plain version and every uniform draw bitwise equal (through the
     kernel's debug output), each call twice and bitwise equal; and, for
     phase 7, the GEMM at mamba2-2.7b's six serving shapes (in_proj N
     10,576, out_proj N 2,560, lm_head N 50,280; M 256 / 1 in the chunk
     lane, 8 in the decode lane: ragged N, split-K over ragged tiles) and
     the draw kernel at (8, 50280) and (1, 50280); then the GEMM's tuned
     knobs: every (tile_m, split_k) the template admits at qwen3's lm_head
     (M = 256), qkv (M = 8) and mamba2's chunk-lane in_proj (M = 256)
     against the plain version (split calls twice, bitwise equal), and at
     the 16 serving shapes the default geometry, the fastest admitted pair
     (a device-time sweep over them all) and torch.matmul, by device time;
     and, for phases 8 and 9: paged decode and paged prefill at the
     serving shapes of qwen2-moe (H = Hkv = 16, G = 1) and granite (32 /
     8, G = 4) in bf16, timed beside SDPA (block_q 16 launches 16 rows at
     G = 1, half the tile's 32 vectors, and 8 at G = 4; logged); the GEMM
     at granite's five serving shapes (qkv 4096 -> 4096 / 1024, mlp_up
     4096 -> 12800, mlp_down 12800 -> 4096, lm_head 4096 -> 49155) and
     qwen2-moe's four (qkv 2048 -> 2048, the shared expert's 2048 -> 5632
     and 5632 -> 2048, lm_head 2048 -> 151936) at M = 8 and 256, timed
     beside torch.matmul; granite's lm_head (N % 8 = 3: the scalar load
     path) at every (tile_m, split_k > 1) the template admits, each split
     call twice and bitwise equal; and the draw kernel at (8, 49155) and
     (4, 49155), whose bf16 logit rows are not 16-byte aligned; and, for
     phases 11-13: paged decode and paged prefill at qwen2-vl's serving
     shape (H = 12, Hkv = 2, G = 6: block_q 16 launches 5 rows, 30 of the
     prefill tile's 32 vectors) in bf16, each twice bitwise, timed beside
     SDPA; the GEMM at qwen2-vl's five serving shapes (qkv 1536 -> 1536 /
     256, mlp_up 1536 -> 8960, mlp_down 8960 -> 1536, lm_head 1536 ->
     151,936) at M = 8 and 256, timed beside torch.matmul; the draw kernel
     at (8 / 4, 32000) and (8 / 4, 51865), the latter's rows not 16-byte
     aligned;
  3. qwen3-1.7b at full width (random weights from seed 0) served through
     `ContinuousEngine` with a plan that sends attention and the four
     role-tagged matmuls through the kernels: 16 requests, chunked and
     packed prefill and decode-only steps, the two step programs captured
     in CUDA graphs and replayed, against the same engine run eagerly
     (`cuda_graphs=False`) in two alternating pairs: every request must
     finish, the pool must drain, `submit()` must capture nothing, each
     graphed engine must capture 2 programs (one signature each) and replay
     every later step, the graphed and eager runs must give the same token
     streams, first-token logits and kernel launches bit for bit (tokens/s
     and TTFT p50 / p95 logged per run, median and spread per lane), every
     kernel must have launched on this path, and the first tokens must
     match the torch lanes (graphed) wherever the reference's top-2 margin
     exceeds the stated tolerance; then on the graphed kernel lanes the
     reference's schedule identities: preempted = unconstrained and
     sharing-on = sharing-off bitwise, chunked vs unchunked and packed vs
     single-segment by first tokens at that margin, with whole-stream
     identity, the first diverging token and the geometry that differs
     logged;
  4. the paper's pipeline on ResNet-18 (batch 1, 224 x 224, f32):
     `optimize_graph`, `select` on device-time fitness (`WallClockFitness`:
     each configuration's calls captured in a CUDA graph and replayed,
     cycling through input copies that L2 cannot hold) with and without the
     vendor lane (the §3.4 ablation), each operator searched by GA and
     RL-search (each one's best, evals and wall seconds, and the winner),
     the per-operator race, both plans run
     graphed (the engine's forward captured in a CUDA graph) and eagerly,
     each graphed forward bitwise equal to its eager one and each held to
     the vendor lane by `Engine.verify_against_reference` and bitwise
     equal to the same plan with its 8 residual chains on ref_ops (a
     registry without the fused entry), one WPK-only forward that must
     launch the conv kernel 20 times, the GEMM once and the elementwise
     kernel 8 times (eagerly, and the same replayed from its graph), and
     the ms per image of seven lanes (both plans also with the chains on
     ref_ops; under --profile the device ms per forward);
  5. the serve plan: the vendor lane of a bf16 matmul (one bf16 cuBLAS
     product, the call serving's torch lane makes) held against the f32
     upcast it replaced at the 10 serving GEMM shapes; qwen3-1.7b's serve
     graph (prefill 700, 8 slots, max_seq 1024, chunk 256, bf16) tuned by
     `build_serve_plan` on device-time fitness on the card (GA and
     RL-search per node, as in phase 4; the flash kernel against the
     vendor lane for the three attention nodes, the GEMM at its tuned
     (tile_m, split_k) for the twelve matmuls, with the count of matmul
     nodes the GEMM wins), the per-node race, then phase 3's 16 requests
     served under `PlanRouter(plan)`, graphed (every request finishes,
     the pool drains, the plan's kernel lanes launch, first tokens match
     the torch lanes; tokens/s beside phase 3's kernel and torch lanes),
     and
     `ops.attention_decode` called once at the decode stage's shape;
  6. sampled serving (run right after phase 3): phase 3's 16 prompts on
     the graphed kernel lanes with the bench's mixed cycle (greedy / T 0.8
     / T 1.0 top-k 8 / T 0.9 top-p 0.85, seed 1000 + i), every token drawn
     by the draw kernel inside the captured step programs (2 launches a
     unified step, 1 a decode-only step): every request finishes and the
     pool drains, graphed = eager bitwise, the greedy requests equal phase
     3's greedy streams, a sampled stream differs from greedy; preempted
     (120-block pool) = unconstrained and sharing-on = sharing-off bitwise;
     `_unified`, `_decode_only` and `_commit` one signature each and `_cow`
     at most one; each commit's host-to-device bytes (counted, and from the
     profiler's memcpy events where it reports them) equal the swapped
     bytes plus the block ids; the commit program's ms; then
     `FixedBatchEngine` at batch 1 on one prompt of each mix, held by first
     tokens where the draw's top-2 margin exceeds 0.25; under --profile the
     draw kernel's device share of the graphed steps;
  7. mamba2-2.7b at full width and 16 of its 64 layers (d_model 2560, 80
     heads x 64, state 128, conv 4, vocab 50,280, bf16, random weights from
     seed 0, initialised on the card) served through `ContinuousEngine` on
     the slot-pooled state cache: phase 3's 16 prompts over this
     vocabulary, 8 slots, 256-token chunks, 32 new tokens.  The kernel
     lanes (the three projections of both ssm stages on the GEMM) graphed
     and eager in one pair: streams, first-token logits and
     launches bitwise equal, one signature per program, captured once,
     replayed steps - 2 times, nothing captured at submit(); tokens/s and
     TTFT, and the captured decode-only step's device ms against its bytes
     bound; the torch lanes (first tokens at the 0.25 margin, first
     diverging token logged); 7 usable state rows for 8 slots preempting,
     bitwise equal to the unconstrained run, `_commit` one signature, each
     commit's host-to-device bytes = the swapped rows + the row ids, the
     commit program's ms; the mixed sampling cycle graphed = eager, its
     greedy requests equal to the first run; `FixedBatchEngine` at batch 1
     on 4 prompts (<= 256 tokens or 512) by first tokens; the ssm serve
     plan raced on device time (6 matmul nodes, GA and RL-search) and 16
     requests served under it (tokens/s beside the kernel and torch
     lanes'); the phase's peak device memory and seconds (--profile: each
     serving run's device-time breakdown and busy share);
  8. qwen2-moe-a2.7b at full width and 8 of its 24 layers (d_model 2048,
     16 / 16 heads x 128, 60 experts top-4 of width 1408 and 4 shared,
     norm_topk off, vocab 151,936, bf16, random weights from seed 0
     drawn on the card one layer at a time by `init_serving`, after every
     earlier model is freed) served through `ContinuousEngine` on the
     paged programs with phase 3's 16 prompts and runtime: the kernel
     lanes (paged attention, the GEMM for qkv, the shared expert and
     lm_head; the router and the routed experts stay torch ops, as the
     reference's einsums) graphed and eager in one pair,
     streams, first-token logits and launches bitwise equal, one
     signature per program, captured once, nothing at submit(), every
     request finished and the pool drained; tokens/s and TTFT; the
     captured decode-only step's device ms against its bytes bound
     (`decoder_decode_bound`: all 60 experts' weights, as capacity
     dispatch reads them, and the slots' KV rows); the torch lanes by
     first tokens at the 0.25 margin; a 120-block pool preempting against
     the unconstrained run, logged and not gated (capacity grouping takes
     in the idle slots' rows, so the MoE's streams depend on the batch,
     in the reference too); the serve plan raced on the card (GA and
     RL-search) and the 16 requests served under it; peak device memory
     and the phase's seconds;
  9. granite-3-8b at full width and depth (40 layers, d_model 4096, 32 /
     8 heads x 128, d_ff 12800, vocab 49,155, bf16, seed 0, the same
     init): the first 8 of phase 3's prompts, the kernel lanes graphed
     and eager in one pair (bitwise), the torch lanes by first tokens at
     the margin, tokens/s, the decode-only step against its bytes bound,
     peak device memory;
 10. the analytic fitness against the card (run right after phase 5):
     every valid configuration of each distinct operator of ResNet-18 (16:
     the convs and the fc, f32), of qwen3-1.7b's serve graph (12 matmul
     and 3 attention nodes, bf16) and of mamba2-2.7b's (6 matmul nodes)
     launched and held against its plain version, timed on device time
     and priced by `ModelFitness`, the vendor lane both ways; per operator
     Spearman's rho, the regret of the model's pick, the backend agreement
     and model / measured at the measured best, per graph their median and
     worst (logged, not gated; gated: every configuration finite and within
     tolerance, the model at or above `kernel_bound`); then ResNet-18's
     plan tuned by `Tuner(fitness=ModelFitness())` (its PPO agent on the
     CPU) run graphed, `verify_against_reference` at 1e-3, ms/image beside
     phase 4's device-time race plan in turns; qwen3-1.7b served under its
     model-tuned serve plan (graphed, first tokens against the torch lanes
     at the 0.25 margin, tokens/s beside phase 5's plan); and qwen3's
     serve-plan race run again on a fresh device-time fitness, with the
     matmul nodes whose winner flips against phase 5's counted;
 11. qwen2-vl-2b at full width and depth (28 layers, d_model 1536, 12 / 2
     heads x 128, M-RoPE sections (16, 24, 24), d_ff 8960, vocab 151,936,
     256 vision tokens, bf16, seed 0, drawn on the card by `init_serving`
     after every earlier model is freed): phase 3's 16 prompts on the
     kernel lanes graphed and eager in one pair (bitwise, one signature
     per program, replays = steps - 2, nothing captured at submit()), the
     decode-only step against its bytes bound, the torch lanes by first
     tokens at the 0.25 margin, a 120-block pool preempting the first 8
     prompts bitwise equal to the unconstrained run; then `ServeEngine`
     with `extras={"vision_embeds": (256, 1536)}` (drawn from the seed),
     routed to the fixed-batch loop, batch 4, 4 prompts of 300-400 tokens:
     every request finishes, its tokens agree with the same parameters
     cast up to f32 (teacher-forced on the bf16 run's tokens: the first
     tokens and every decode step's) wherever the f32 top-2 margin
     exceeds 0.25 (at least one token compared; the first tokens' max
     logit error logged), and the first-token logits differ from the same
     prompts served without the images;
 12. zamba2-1.2b (`HybridLM`, 38 Mamba2 layers, d_model 2048, the shared
     block used 6 times, 32 / 32 heads x 64, d_ff 8192, state 64, vocab
     32,000) through `ServeEngine`, routed to the fixed-batch loop: batch
     4, max_seq 512, 8 prompts of 32-256 tokens, 32 new tokens; every
     request finishes, tokens agree with the f32 twin as in phase 11;
     tokens/s (`throughput()`) and prefill seconds;
 13. whisper-base (`EncDecLM`, 6 + 6 layers, d_model 512, 8 heads x 64,
     d_ff 2048, vocab 51,865, layer norm, gelu) with `extras=
     {"audio_embeds": (1500, 512)}` drawn from the seed, batch 4, 8
     prompts of 4-64 tokens: phase 12's gates.  Phases 11-13 each log
     their peak device memory and seconds and free the card for the
     next;
 14. training qwen3-1.7b at full width and depth (28 layers, 2.03 G
     parameters; `remat="full"`) through `launch/steps.py::make_train_step`,
     the step `Trainer.run` calls: f32 master weights from seed 0 on the
     card, bf16 compute, `SyntheticLMData` (seq 1024, batch 8), 2
     microbatches, AdamW (lr 3e-4, warm-up 5, 40 total); step 1's loss and
     global gradient norm against an f32 twin (the same config in f32, TF32
     off, same parameters and batch; each leaf's gradient cosine logged);
     2 warm-up and 12 timed steps: step ms (median, min, max), tokens/s,
     MFU, the loss every step (its last 5 must average below the first),
     peak device memory; the AdamW update alone by CUDA events beside its
     bytes bound; one step under torch.profiler (device events per step,
     busy share); no hand-written kernel launched; then the dry run's
     cross-check: the same step lowered on the meta device with
     `launch/dryrun.py`'s meters against one real step on the card under
     FlopCounterMode and `launch/costcount.py`'s CostCounter (FLOPs, bytes
     accessed and transcendentals must each agree within 0.1 %, else the
     ops that differ are named and the phase fails), the meta argument
     bytes beside the state the card holds, MemTracker's peak beside the
     measured one, MFU from the counted FLOPs beside the 6 N T figure, and
     the step's counted roofline, max(FLOPs / 989 TFLOP/s, bytes / 3.35
     TB/s), beside the measured step (logged, not gated);
 15. `Trainer` end to end at `examples/train_lm.py`'s configuration (qwen3
     reduced to 4 layers, d_model 256, vocab 4096; seq 128, batch 8, 2
     microbatches, 200 steps, a checkpoint every 25): the loss falls, the
     last checkpoint restores leaf for leaf, and a run stopped by the
     PREEMPT sentinel at step 100 and resumed by a fresh Trainer ends
     equal to the uninterrupted run (bitwise, or the differing leaves
     named and held at 1e-6); then one train step of qwen2-moe-a2.7b,
     mamba2-2.7b and qwen2-vl-2b at 2 layers, zamba2-1.2b at 6 (one shared
     block use) and whisper-base whole, at full width (batch 2, seq 1024;
     whisper 448 with 1500 audio frames; the vlm's 256 vision embeddings),
     each against its f32 twin as in phase 14, with its peak memory; no
     hand-written kernel launched;
 16. long-KV attention (`models/attention.py::_sdpa`, the chunked online
     softmax from 1024 keys on, as the reference): attention alone at
     qwen3-1.7b's heads (B 4, S 4096, 16 / 8 x 128, causal, bf16), forward
     and backward in the direct and the chunked form, each one's ms and
     peak memory above its inputs, outputs and gradients agreeing at
     2e-2 x max; qwen3-1.7b trained at seq 4096 x batch 8 (2 microbatches,
     remat full; 1 warm-up and 1 timed step: step ms, tokens/s, peak, the
     loss finite, no hand-written kernel); one 32,768-token prompt through
     the fixed-batch `prefill_step` with no autograd graph (seconds, peak)
     and through a one-slot `ContinuousEngine` on the graphed kernel lanes
     (block tables of 2,050 blocks), first tokens compared at the 0.25
     margin;
 17. internlm2-20b (48 layers, d_model 6144, 48 / 8 heads x 128, d_ff
     16,384, vocab 92,544; 39.72 GB) and
 18. starcoder2-15b (40 layers, 48 / 4 heads: G = 12, d_ff 24,576, vocab
     49,152; 43.99 GB) at full width and depth, bf16, drawn on the card by
     `init_serving` after every earlier model is freed, each in phase 9's
     pattern on the first 8 prompts: the kernel lanes graphed and eager in
     one pair, bitwise equal, one signature per program; the captured
     decode-only step against its bytes bound; the torch lanes by first
     tokens at the 0.25 margin; tokens/s and peak memory (phase 2 first
     holds paged decode / prefill at G 6 and 12, the GEMM at both models'
     shapes and the draw at V 92,544 / 49,152);
 19. the mesh: `launch/mesh.py::single_device_mesh()` in this process (a
     world of one on nccl), qwen3-1.7b's `params_shardings` under
     `rules_for_shape(cfg, SHAPES["decode_32k"], mesh)`, every leaf
     `Replicate()`, one leaf as a DTensor; the group destroyed after;
 20. the layout race: qwen3-1.7b's serve plan tuned with model_parallel
     2 / 4 / 8 on device time (random search, 4 configurations a
     template), each stage node's replicated and model-parallel times (the
     shard shape's race plus the priced collective) and verdict, every
     divisible node raced and no other, the verdict the faster, the plan
     through save / load, `serve_rules` of each plan and of none;
 21. tensor-parallel serving: (a) qwen3-1.7b's kernel lanes on
     `tp_mesh(1)` (a world of one on nccl), graphed, bitwise equal to the
     engine with no mesh (streams, first-token logits, launches, captures
     and replays), then eagerly on the first 8 prompts at the ranks' depth
     (8 of the 28 layers: an earlier path, cut for the time limit); (b)
     tp = 2 and 4 as
     2 and 4 processes sharing the card, each width a gloo world over a
     FileStore, the two worlds side by side (phases 22 and 23 likewise)
     (`--tp-child`), every kernel built before they start, each rank on
     its shards, eagerly: streams equal on every rank, every token held
     against the dense torch path where its top-2 margin exceeds 0.25, one
     signature per program and nothing captured at admission, each rank's
     launches of paged decode / prefill, the GEMM and the draw, its peak
     memory and tokens/s (phase 2 first holds paged decode / prefill at the
     ranks' heads for tp = 2 / 4 / 16 and the GEMM at the shard shapes for
     tp = 2 / 4);
 22. tensor-parallel serving of the other ContinuousEngine families:
     qwen2-vl-2b, mamba2-2.7b and qwen2-moe-a2.7b at full width and a cut
     depth on their kernel-lane plans and the first 8 prompts: (a) each with no
     mesh and on `tp_mesh(1)`, graphed, bitwise equal, then on
     `tp_mesh(1)` eagerly; (b) tp = 2 and 4 as gloo worlds of processes on
     the card (`--tp-family-child`), each rank serving the three models in
     turn, each drawn from the seed straight into the rank's shards (the
     MoE's experts split on E, mamba2's heads and conv channels
     head-aligned, the vlm's KV heads as its query heads read them):
     streams equal on every rank, one signature per program, nothing
     captured, every request drained, launches equal to the tp = 1 eager
     run's, each rank's peak within its shards plus one full leaf in f32
     and its f32 shard (what `init_serving(tp=)` holds at once);
     (c) every stream replayed teacher-forced through the tp = 1 torch
     lanes (`forced_check`), each token with a top-2 margin > 0.25 its
     argmax (phase 2 first holds paged decode / prefill at the MoE's and
     the vlm's rank heads and the GEMM at the three models' shard shapes,
     tp = 2 / 4).  (a), (b) and (c) serve the three models at full width
     and a cut depth (TP_FAMILY_CHILD_LAYERS: 4 / 8 / 4 layers);
 23. the fixed-batch loop on a mesh: zamba2-1.2b (12 of its 38 layers) and
     whisper-base (1500 audio frames) at full width, one batch of 4 prompts
     each through `FixedBatchEngine` under the guarded rules (whisper's
     odd vocabulary splits the LM head's rows): (a) no mesh and
     `tp_mesh(1)` bitwise equal (streams, first-token logits, launches);
     (b) tp = 2 and 4 as gloo worlds of processes on the card
     (`--tp-fixed-child`), each rank serving both models, each drawn from
     the seed straight into the rank's shards: streams equal on every
     rank, draw-kernel launches equal to tp = 1's, each rank's peak within
     its shards + its caches + the larger of one full leaf in f32 and the
     tp = 1 run's activations; (c) every stream
     replayed teacher-forced through the tp = 1 loop, each token with a
     top-2 margin > 0.25 its argmax;
 24. training on a mesh: qwen3-1.7b at phase 14's configuration (full
     width, 2 layers, remat full, seq 1024 x batch 8, 2
     microbatches, seed 0) through `Trainer(model, mesh, rules, data, cfg)`
     and its rank step (`launch/steps.py::mesh_train_step`) on a (data 1,
     model 2) and a (data 2, model 1) mesh with ZeRO-1, each a gloo world of
     two processes sharing the card (`--train-tp-child`), the two side by
     side, then one world of 4 processes running ROADMAP 8c-ii's layouts:
     qwen3-1.7b (2 layers) on (pod 2, data 2, model 1), the batch over pod
     x data, and zamba2-1.2b (6 layers) on one sequence of 16,384 tokens
     over (data 2, model 2), "seq" over "data"; every rank draws the
     single-device state from the seed and keeps its cut, computes the
     step-1 gradients (loss within 1e-3 of the no-mesh step at the same
     depth, which this process runs first, the global norm within 1e-2
     relative, every gathered leaf's cosine with the no-mesh step-1
     gradient >= 0.999) and runs 1 step: loss and grad_norm the same bits
     on every rank, the replicated leaves bitwise equal across ranks after
     it, no hand-written kernel launched; each rank's peak memory beside
     the shards + gradients + moments + activations reckoned before the
     run, the least free memory on the card during the steps (every
     process's use), and its step ms (gloo on one card: not a DP / TP
     speed).  Then the elastic restart at phase 15's Trainer
     configuration: the (data 1, model 2) world trains and saves, and this
     process, with no mesh, restores the checkpoint bitwise equal to the
     state the ranks gathered;
 25. serving on a (data 2, model 2) mesh, the serving layouts of the
     production meshes, as one world of 4 gloo processes sharing the card
     (`--dp-serve-child`), eager, each model at full width and a cut depth
     drawn from seed 0 straight into each rank's shards:
     qwen2-moe-a2.7b (2 layers) with the batch over "data" and TP inside
     the experts ("experts" replicated, "expert_ffn" over "model"), batch
     4 and 8 prompts: streams equal on every rank, every decode step's
     dropped (token, choice) pairs those of the same engine with no mesh,
     and the tokens held to a teacher-forced replay through it;
     qwen3-1.7b (2 layers), prompts up to 700 tokens, "kv_heads"
     replicated and "kv_seq" over "model": streams equal on every rank and
     held to the replay, each rank's cache exactly its reckoned cut and
     its serving peak within shards + that cache + the no-mesh run's
     transient (its draw's within shards + one f32 full leaf and its f32
     shard); the sequence-parallel prefill at batch 1 under
     `rules_for_shape`'s long_500k layout (the batch replicated, "seq",
     "kv_seq" and "ssm_state" over "data") of zamba2-1.2b (6 layers, a
     16,128-token prompt: each rank's block 31.5 chunks of 256) and
     mamba2-2.7b (4 layers, 16,384 tokens), each through `prefill_step`
     (the logits bitwise equal on every rank and within 0.05 x max |logit|
     of the no-mesh prefill's, each rank's conv / SSM carries and K / V
     within 0.05 x max of the no-mesh cache's `local_cache` cut or twice
     the error of the rank's prefill with the whole prompt on every rank
     (tensor parallelism's own rounding, logged), each rank's prefill
     peak below the no-mesh prefill's), then 8 decode
     steps fed the no-mesh stream (within 0.05 x max at every step,
     margin tokens agree) and through FixedBatchEngine (32 tokens, the
     streams equal on every rank and to the no-mesh stream up to a token
     of top-2 margin <= 0.25, 32 draw launches a rank); the draw kernel's
     launches per rank equal the no-mesh runs';
 26. the port's examples (`repro_torch.examples`), run right after phase 4
     in this process at their JAX examples' sizes: quickstart (its engine
     within `verify_against_reference`'s 2e-2 of the vendor lane),
     tune_resnet18 on phase 4's device-time fitness (one row a conv group,
     the warm-cache re-tune all hits) and serve_inference (12 of 12
     requests continue the learned sequence exactly); each one's output,
     seconds and hand-written launches logged;
 27. one JSON line `{"kernels": [...]}` with each kernel's launches on each
     path (the eager and the graphed forward are separate paths, as are
     the knob sweep, the races of phases 4, 5, 7, 8, 10 and 20, their
     serving runs, the decode wrapper's call, the fixed-batch runs of
     phases 11-13, 23 and 25, where only the draw kernel runs, the 32k
     engine run of phase 16, the serving runs of phases 17-18, 21 and 22,
     each rank's its own path, each example its own; a replayed CUDA graph
     counts the launches it captured), error and times;
 28. the last line `{"ok": true, "device": {...}}`.

It imports nothing of JAX or of the JAX package.  Without a GPU it exits
nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, dense bf16
# tensor-core rate and FP32 CUDA-core rate; the bound of a call is the
# larger of bytes / HBM_BPS and flops / the peak of the work's type
# (BF16_FLOPS for bf16, F32_FLOPS for f32), with each input read once and
# each output written once.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
L2_BYTES = 50 * 2**20
H100_SMS = 132
DEVICE = "cuda"
PREFILL_BLOCK_Q = 16     # rows per prefill CTA: 16 rows x G=2 heads fill the
                         # 32-vector tile (2 query warps x 16 vectors)
# the libraries that run on the tensor cores (mma.sync): the bf16 instances
# of all four, and the conv's f32 instances as 3xTF32
TENSOR_CORE_LIBS = ("flash_attention", "paged_prefill", "matmul", "conv2d")


def log(*args):
    print(*args, flush=True)


# ------------------------------------------------------------------ timing
def time_ms(torch, fns, iters=20, warmup=2):
    """Mean ms of one call, cycling through `fns` (closures over distinct
    copies of the inputs, so the 50 MB L2 holds none of them from one call
    to the next, as in a serving step that walks every layer's weights)."""
    for i in range(warmup * len(fns)):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n = max(iters, len(fns))
    start.record()
    for i in range(n):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(torch, fns, calls=20, replays=5):
    """Device ms of one call: `calls` calls cycling through `fns` (as
    `time_ms` does, so the inputs come from device memory as there) captured
    in a CUDA graph, replayed `replays` times, CUDA events around the
    replays — no host time between launches, so a small call's own time
    shows."""
    calls = max(calls, len(fns))
    for fn in fns:
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(calls):
            fns[i % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def copies_for(nbytes):
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(1, nbytes))))


def bound(nbytes, flops, peak=BF16_FLOPS):
    t_bytes, t_flops = nbytes / HBM_BPS, flops / peak
    return (1e3 * max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def _ms(t):
    return "n/a" if t is None else f"{t:.4f}"


class Check:
    """Accumulates one kernel's comparisons and timings."""

    def __init__(self, name, source, replaces, fn):
        self.name, self.source, self.replaces, self.fn = name, source, replaces, fn
        self.err = 0.0
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.library_ms = 0.0
        self.bound_parts = [0.0, 0.0]
        self.shapes = []

    def compare(self, label, got, want, tol, why):
        torch = sys.modules["torch"]
        err = (got.float() - want.float()).abs().max().item()
        ok = math.isfinite(err) and err <= tol
        log(f"  {self.name} {label}: max_abs_err {err:.3e} tol {tol:.1e} "
            f"({why}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{self.name} {label}: error {err} > tol {tol}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{self.name} {label}: non-finite output")
        return err

    def timed(self, label, kernel_fns, plain_fns, library_fns, nbytes, flops,
              peak=BF16_FLOPS, weight=1, device=False):
        """Time one shape; `weight` is how many times the main path runs
        it (the record sums weight x each time; 0 for a checked shape the
        main path does not run, which is logged and listed only).
        `device`: also the kernel's and the library call's device time
        (`graph_ms`; the library's n/a where there is no library call),
        listed per shape."""
        torch = sys.modules["torch"]
        k = time_ms(torch, kernel_fns)
        p = time_ms(torch, plain_fns)
        lib = time_ms(torch, library_fns) if library_fns else None
        b, by = bound(nbytes, flops, peak)
        dev = {}
        if device:
            dev["device_ms"] = graph_ms(torch, kernel_fns)
            dev["library_device_ms"] = graph_ms(torch, library_fns) if library_fns else None
        if weight:
            self.ms += weight * k
            self.plain_ms += weight * p
            self.library_ms = None if lib is None or self.library_ms is None \
                else self.library_ms + weight * lib
            self.bound_parts[0] += weight * nbytes / HBM_BPS * 1e3
            self.bound_parts[1] += weight * flops / peak * 1e3
            self.bound_ms += weight * b
        self.shapes.append({"shape": label, "weight": weight, "ms": k,
                            "plain_ms": p, "library_ms": lib, "bound_ms": b,
                            "bound_by": by, **dev})
        tag = {0: " (not on the main path)", 1: ""}.get(weight, f" (x{weight} per pass)")
        log(f"  {self.name} {label}{tag}: "
            f"kernel_ms {k:.4f} plain_ms {p:.4f} "
            f"library_ms {_ms(lib)} "
            f"bound_ms {b:.4f} ({by}; {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP)"
            + ("" if not dev else f"; device (CUDA graph) kernel_ms "
               f"{dev['device_ms']:.4f} library_ms {_ms(dev['library_device_ms'])}"))

    def record(self, paths):
        """`paths`: {path name: launches of this kernel on that path}."""
        return {
            "name": self.name, "route": "cuda", "source": self.source,
            "replaces": self.replaces, "launches": sum(paths.values()),
            "paths": paths,
            "max_abs_err": self.err, "ms": self.ms, "plain_ms": self.plain_ms,
            "bound_ms": self.bound_ms,
            "bound_by": ("bytes" if self.bound_parts[0] >= self.bound_parts[1]
                         else "operations"),
            "library_ms": self.library_ms,
            "shapes": self.shapes,
        }


# -------------------------------------------------------------- phase 1
def phase_environment(torch):
    from repro_torch.kernels import build
    from repro_torch.platform import require_sm90

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"compute capability {require_sm90()} (sm_90a kernels)")
    t0 = time.perf_counter()
    seconds = build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
        + ", ".join(f"{n} {s:.1f} s" for n, s in seconds.items()))
    for name in build.SOURCES:
        func = "?"
        for line in build.build_log(name).splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                func = m.group(1)
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {func}: {line.strip()}")
    # the tensor-core tile shows in the machine code as HMMA (mma.sync) or
    # HGMMA (wgmma) instructions
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dumps = {name: subprocess.Popen([tool, "--dump-sass", str(build.lib_path(name))],
                                    stdout=subprocess.PIPE, text=True)
             for name in TENSOR_CORE_LIBS}              # side by side
    for name, proc in dumps.items():
        sass = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"cuobjdump --dump-sass {name}: exit {proc.returncode}")
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HMMA", "HGMMA")}
        log(f"  sass {name}: {counts}")
        if counts["HMMA"] + counts["HGMMA"] == 0:
            raise AssertionError(f"{name}: no tensor-core instruction in its library")
    return smi


# -------------------------------------------------------------- phase 2
# The bf16 tolerances.  The plain attention versions are the JAX gather
# lanes: Q·Kᵀ rounded to bf16 before the f32 scale and softmax, where the
# kernels (like the Pallas kernels) keep Q·Kᵀ in f32.  With unit-variance q
# and k (qk-norm output) at D = 128 the unscaled Q·Kᵀ reaches ~|40|, whose
# bf16 rounding (2^-9 relative) moves a scaled logit by up to ~0.02, the
# probabilities by ~2% relative, and so an output of unit-scale V by a few
# 1e-2; 6e-2 bounds that.  Against an f32-math reference on the same bf16
# inputs only the kernels' own roundings remain (p to bf16, 2^-9 relative,
# and the bf16 output), so 2e-2 holds there.  The GEMM's plain version has
# the kernel's arithmetic (f32 accumulate, one rounding): the two differ
# by summation order, i.e. at most about one bf16 ulp of the output,
# 2^-7 relative: tolerance 1e-2 x max(1, max |ref|).  In f32 everything is
# the same algorithm up to summation order: 2e-5 (the JAX tests' own
# tolerance) for attention, 1e-5 x max(1, max |ref|) for the GEMM.
ATT_TOL_PLAIN_BF16 = 6e-2
ATT_TOL_F32MATH_BF16 = 2e-2
ATT_TOL_F32 = 2e-5
MM_RTOL_BF16 = 1e-2
MM_RTOL_F32 = 1e-5


def _gather_kv(torch, k_pool, v_pool, tables):
    """(B, Hkv, nbt*bs, D) contiguous K/V of each table row."""
    b, nbt = tables.shape
    bs, hkv, d = k_pool.shape[1:]
    k = k_pool[tables.long()].reshape(b, nbt * bs, hkv, d).transpose(1, 2)
    v = v_pool[tables.long()].reshape(b, nbt * bs, hkv, d).transpose(1, 2)
    return k.contiguous(), v.contiguous()


# the decode and chunk lanes' head geometries: (model, H, Hkv); qwen3's
# runs in phase 3, qwen2-moe's (G = 1, MHA) in phase 8, granite's (G = 4)
# in phase 9, qwen2-vl's (G = 6: block_q 16 launches 5 rows, 30 of the
# prefill tile's 32 vectors) in phase 11, internlm2's (G = 6) in phase 17,
# starcoder2's (G = 12: decode on the MAXG = 16 instance, prefill 2 rows,
# 24 of 32 vectors) in phase 18
SERVE_HEADS = (("qwen3-1.7b", 16, 8), ("qwen2-moe-a2.7b", 16, 16),
               ("granite-3-8b", 32, 8), ("qwen2-vl-2b", 12, 2),
               ("internlm2-20b", 48, 8), ("starcoder2-15b", 48, 4))


def _decode_serving_shape(torch, chk, g, model, h, hkv):
    """Paged decode at a model's serving shape in bf16: 8 slots, block_size
    16, 64-block tables over the serving pool (8 x 64 + 1 blocks); slot 4
    is an inactive slot (all-null table, length 1, as the serving path
    passes it).  Against the plain version and an f32-math reference,
    twice bitwise, timed beside SDPA."""
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import ref as R

    F = torch.nn.functional
    dev = DEVICE
    b, d, bs, nbt = 8, 128, 16, 64
    nb = b * nbt + 1
    lengths = torch.tensor([1, 16, 17, 1000, 1, 250, 513, 1024],
                           dtype=torch.int32, device=dev)
    perm = torch.randperm(nb - 1, generator=g, device=dev)[: b * nbt] + 1
    tables = perm.reshape(b, nbt).to(torch.int32)
    tables[4] = 0
    real = [i for i in range(b) if i != 4]
    q = torch.randn((b, h, d), generator=g, device=dev).to(torch.bfloat16)
    kp = torch.randn((nb, bs, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((nb, bs, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    nsplit, kps = KA.decode_splits(nbt, bs)
    if nsplit < 2:
        raise AssertionError(f"paged decode at nbt={nbt} bs={bs}: no split-KV")
    out = KA.paged_decode_attention(q, kp, vp, lengths, tables)
    want = R.paged_decode_attention_ref(q, kp, vp, lengths, tables)
    tag = f"{model} G={h // hkv} bf16"
    chk.err = max(chk.err, chk.compare(
        f"{tag} vs plain (real slots; grid {b} x {hkv} x {nsplit} splits of "
        f"{kps} keys)", out[real], want[real],
        ATT_TOL_PLAIN_BF16, "f32 vs bf16 Q·Kᵀ rounding"))
    exact = R.paged_decode_attention_ref(q.float(), kp.float(), vp.float(),
                                         lengths, tables)
    chk.compare(f"{tag} vs f32-math reference", out[real], exact[real],
                ATT_TOL_F32MATH_BF16, "p and output rounded to bf16")
    _bitwise(chk, f"{tag} serving shape", out,
             KA.paged_decode_attention(q, kp, vp, lengths, tables))

    n_copy = copies_for(2 * kp.numel() * 2)
    pools = [(kp, vp)] + [(kp.clone(), vp.clone()) for _ in range(n_copy - 1)]
    kfns = [lambda kq=kq, vq=vq: KA.paged_decode_attention(q, kq, vq, lengths, tables)
            for kq, vq in pools]
    pfns = [lambda kq=kq, vq=vq: R.paged_decode_attention_ref(q, kq, vq, lengths, tables)
            for kq, vq in pools]
    kk, vv = _gather_kv(torch, kp, vp, tables)
    pos = torch.arange(nbt * bs, device=dev)
    mask = (pos[None, :] < lengths[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    libs = [lambda: F.scaled_dot_product_attention(qs, kk, vv, attn_mask=mask,
                                                   enable_gqa=True)]
    rows = int(lengths.sum())
    nbytes = 2 * q.numel() * 2 + 2 * rows * hkv * d * 2 + (tables.numel() + b) * 4
    flops = 4 * rows * h * d
    chk.timed(f"{model} B={b} H={h} Hkv={hkv} D={d} bs={bs} nbt={nbt} bf16 "
              "(library: SDPA over pre-gathered K/V, gather excluded)",
              kfns, pfns, libs, nbytes, flops, device=True)


def check_decode(torch, chk):
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import ref as R

    dev = DEVICE
    g = torch.Generator(device=dev).manual_seed(1)
    for model, h, hkv in SERVE_HEADS:
        _decode_serving_shape(torch, chk, g, model, h, hkv)
    h, hkv, d, bs = 16, 8, 128, 16
    # split edges in bf16: lengths that leave whole splits empty, one block
    # short of a split edge, at it and one past it, a length of 0 (zeros),
    # an inactive slot (all-null table, length 1); 64-block and 1-block
    # tables
    for nbt_, lens in ((64, (0, 112, 128, 129, 1, 255, 256, 1024)), (1, (0, 1, 15, 16))):
        nb_ = len(lens) * nbt_ + 1
        q_ = torch.randn((len(lens), h, d), generator=g, device=dev).to(torch.bfloat16)
        kp_ = torch.randn((nb_, bs, hkv, d), generator=g, device=dev).to(torch.bfloat16)
        vp_ = torch.randn((nb_, bs, hkv, d), generator=g, device=dev).to(torch.bfloat16)
        tables_ = (torch.randperm(nb_ - 1, generator=g, device=dev)[: len(lens) * nbt_]
                   + 1).reshape(len(lens), nbt_).to(torch.int32)
        tables_[lens.index(1)] = 0                       # the inactive slot
        lengths_ = torch.tensor(lens, dtype=torch.int32, device=dev)
        out_ = KA.paged_decode_attention(q_, kp_, vp_, lengths_, tables_)
        want_ = R.paged_decode_attention_ref(q_.float(), kp_.float(), vp_.float(),
                                             lengths_, tables_)
        label = f"bf16 nbt={nbt_} lengths {lens} ({KA.decode_splits(nbt_, bs)[0]} splits)"
        chk.compare(f"{label} vs f32-math reference", out_, want_,
                    ATT_TOL_F32MATH_BF16, "p and output rounded to bf16; length 0 "
                    "gives zeros")
        _bitwise(chk, label, out_, KA.paged_decode_attention(q_, kp_, vp_, lengths_,
                                                            tables_))

    # f32 at tests/test_serving_runtime.py's shapes (first row), then other
    # head geometries: G = 1 / 8 / 4, D = 64 / 128 / 256, block 8 / 32 / 16,
    # and G = 16 over 5 splits with a length of 0
    for b, h, hkv, d, bs, nbt, lens in [(3, 4, 2, 16, 8, 4, (5, 19, 32)),
                                        (2, 8, 8, 64, 8, 5, (40, 1)),
                                        (2, 32, 4, 128, 32, 3, (70, 96)),
                                        (2, 16, 4, 256, 16, 4, (33, 64)),
                                        (4, 16, 1, 128, 16, 40, (0, 300, 640, 129))]:
        nb = b * nbt + 1
        q = torch.randn((b, h, d), generator=g, device=dev)
        kp = torch.randn((nb, bs, hkv, d), generator=g, device=dev)
        vp = torch.randn((nb, bs, hkv, d), generator=g, device=dev)
        tables = (torch.randperm(nb - 1, generator=g, device=dev)[: b * nbt] + 1
                  ).reshape(b, nbt).to(torch.int32)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        want = R.paged_decode_attention_ref(q, kp, vp, lengths, tables)
        chk.compare(f"f32 H={h} Hkv={hkv} D={d} bs={bs} lengths {lens} "
                    f"({KA.decode_splits(nbt, bs)[0]} splits) vs plain",
                    KA.paged_decode_attention(q, kp, vp, lengths, tables), want,
                    ATT_TOL_F32, "same algorithm, f32 summation order")


def _prefill_case(torch, g, c, h, hkv, d, bs, nbt, nb, segs, dtype):
    """Random inputs for one packed chunk: segs = [(seg_len, kv_start)],
    packed from row 0; disjoint per-segment tables."""
    dev = DEVICE
    ns = len(segs)
    q = torch.randn((1, c, h, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((nb, bs, hkv, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((nb, bs, hkv, d), generator=g, device=dev).to(dtype)
    perm = torch.randperm(nb - 1, generator=g, device=dev)[: ns * nbt] + 1
    tables = perm.reshape(ns, nbt).to(torch.int32)
    info, q0 = [], 0
    for i, (n, kv0) in enumerate(segs):
        info.append((q0, n, kv0))
        if n == 0:
            tables[i] = 0
        q0 += n
    info = torch.tensor(info, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, info


def _real_rows(info):
    return [r for q0, n, _ in info.tolist() for r in range(q0, q0 + n)]


def _prefill_yardsticks(torch, q, kp, vp, tables, info, rotate=False):
    """The library call for one packed chunk — one SDPA over its segments
    batched and padded, with their K/V already gathered contiguous (the
    gather is not timed; `rotate`: cycling through copies of the gathered
    K/V, as the kernel's timing cycles through pool copies) — and the bytes
    and flops of its bound."""
    F = torch.nn.functional
    dev = DEVICE
    h, d = q.shape[2], q.shape[3]
    hkv = kp.shape[2]
    live = [(i, q0, n, kv0) for i, (q0, n, kv0) in enumerate(info.tolist()) if n]
    lq = max(n for _, _, n, _ in live)
    lk = max(kv0 + n for _, _, n, kv0 in live)
    qb = torch.zeros((len(live), h, lq, d), dtype=q.dtype, device=dev)
    mask = torch.zeros((len(live), 1, lq, lk), dtype=torch.bool, device=dev)
    kk, vv = _gather_kv(torch, kp, vp, tables[[i for i, *_ in live]])
    kk, vv = kk[:, :, :lk].contiguous(), vv[:, :, :lk].contiguous()
    rows_keys = 0
    for j, (_, q0, n, kv0) in enumerate(live):
        qb[j, :, :n] = q[0, q0:q0 + n].transpose(0, 1)
        qpos = kv0 + torch.arange(n, device=dev)
        mask[j, 0, :n] = torch.arange(lk, device=dev)[None, :] <= qpos[:, None]
        mask[j, 0, n:, 0] = True
        rows_keys += sum(kv0 + r + 1 for r in range(n))
    copies = copies_for(2 * kk.numel() * kk.element_size()) if rotate else 1
    kvs = [(kk, vv)] + [(kk.clone(), vv.clone()) for _ in range(copies - 1)]
    libs = [lambda k=ki, v=vi: F.scaled_dot_product_attention(
        qb, k, v, attn_mask=mask, enable_gqa=True) for ki, vi in kvs]
    kv_rows = sum(kv0 + n for _, _, n, kv0 in live)
    item = q.element_size()
    nbytes = item * (2 * q.numel() + 2 * kv_rows * hkv * d) + tables.numel() * 4
    return libs, nbytes, 4 * rows_keys * h * d


# bf16 prefill chunks where the tensor-core tile is most likely wrong: a
# warp's 16 vectors straddling two segments, rows past the fill, idle
# segments, pool blocks of 8 and 32, D = 64 / 128 / 256, G = 1 / 2 / 4 / 8:
# (H, Hkv, D, block_size, [(seg_len, kv_start)], padding rows, block_q)
PREFILL_BF16_CASES = [
    (8, 8, 64, 8, [(5, 0), (11, 40), (0, 0), (9, 3)], 7, None),
    (16, 8, 128, 32, [(7, 100), (13, 0), (0, 0), (6, 33)], 4, 16),
    (16, 4, 256, 8, [(3, 17), (6, 0), (5, 64)], 6, None),
    (32, 4, 64, 32, [(2, 5), (3, 70), (0, 0), (1, 0)], 3, None),
    (16, 16, 256, 32, [(19, 0), (0, 0), (9, 90)], 5, 8),
]


def _check_prefill_bf16(torch, chk, label, q, kp, vp, tables, info, block_q):
    """One bf16 chunk against the plain version and an f32-math reference
    (real rows), and rows past the fill exactly zero."""
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import ref as R

    real = _real_rows(info)
    out = KA.paged_prefill_attention(q, kp, vp, tables, info, block_q=block_q)
    want = R.packed_prefill_attention_ref(q, kp, vp, tables, info)
    chk.err = max(chk.err, chk.compare(
        f"{label} vs plain (real rows)", out[0, real], want[0, real],
        ATT_TOL_PLAIN_BF16, "f32 vs bf16 Q·Kᵀ rounding"))
    exact = R.packed_prefill_attention_ref(q.float(), kp.float(), vp.float(),
                                           tables, info)
    chk.compare(f"{label} vs f32-math reference", out[0, real], exact[0, real],
                ATT_TOL_F32MATH_BF16, "p and output rounded to bf16")
    pad = [r for r in range(q.shape[1]) if r not in set(real)]
    if pad and bool(out[0, pad].abs().max() != 0):
        raise AssertionError(f"prefill {label}: rows past the fill are not zeros")


def _prefill_serving_shape(torch, chk, g, model, h, hkv, block_q):
    """Paged prefill at a model's chunk-lane shape in bf16: chunk 256, a
    fresh segment, a resumed one (kv_start 544 > 0), a mid-prompt
    continuation, an idle segment, and 6 padding rows past the fill;
    `block_q` as the serving plan passes it (the kernel clamps it to
    32 / G rows, `kernels.attention.prefill_block_q`)."""
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import ref as R

    c, d, bs, nbt = 256, 128, 16, 64
    nb = 8 * nbt + 1
    segs = [(120, 0), (100, 544), (30, 16), (0, 0)]
    q, kp, vp, tables, info = _prefill_case(torch, g, c, h, hkv, d, bs, nbt, nb,
                                            segs, torch.bfloat16)
    rows = KA.prefill_block_q(block_q, c, h // hkv)
    tag = f"{model} G={h // hkv} bf16"
    log(f"  paged_prefill_attention {tag}: block_q {block_q} launches {rows} query "
        f"rows x {h // hkv} heads = {rows * (h // hkv)} of the tile's "
        f"{KA.PREFILL_MAX_VECTORS} vectors a CTA")
    _check_prefill_bf16(torch, chk, tag, q, kp, vp, tables, info, block_q)
    _bitwise(chk, f"{tag} serving shape",
             KA.paged_prefill_attention(q, kp, vp, tables, info, block_q=block_q),
             KA.paged_prefill_attention(q, kp, vp, tables, info, block_q=block_q))

    n_copy = copies_for(2 * kp.numel() * 2)
    pools = [(kp, vp)] + [(kp.clone(), vp.clone()) for _ in range(n_copy - 1)]
    kfns = [lambda kq=kq, vq=vq: KA.paged_prefill_attention(
        q, kq, vq, tables, info, block_q=block_q) for kq, vq in pools]
    pfns = [lambda kq=kq, vq=vq: R.packed_prefill_attention_ref(
        q, kq, vq, tables, info) for kq, vq in pools]
    libs, nbytes, flops = _prefill_yardsticks(torch, q, kp, vp, tables, info,
                                              rotate=True)
    chk.timed(f"{model} C={c} S=4 (fill {len(_real_rows(info))}, kv_start 544 "
              f"resumed, 1 idle) H={h} Hkv={hkv} D={d} block_q={block_q} ({rows} "
              "rows launched) bf16 (library: SDPA over pre-gathered, padded K/V, "
              "gather excluded)", kfns, pfns, libs, nbytes, flops, device=True)


def check_prefill(torch, chk, block_q):
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import ref as R

    g = torch.Generator(device=DEVICE).manual_seed(2)
    for model, h, hkv in SERVE_HEADS:
        _prefill_serving_shape(torch, chk, g, model, h, hkv, block_q)

    for h, hkv, d, bs, segs, pad, bq in PREFILL_BF16_CASES:
        c = sum(n for n, _ in segs) + pad
        nbt = -(-max(kv0 + n for n, kv0 in segs) // bs)
        q, kp, vp, tables, info = _prefill_case(
            torch, g, c, h, hkv, d, bs, nbt, len(segs) * nbt + 1, segs,
            torch.bfloat16)
        label = (f"bf16 C={c} segs {segs} H={h} Hkv={hkv} D={d} bs={bs} "
                 f"block_q={bq}")
        _check_prefill_bf16(torch, chk, label, q, kp, vp, tables, info, bq)
        libs, nbytes, flops = _prefill_yardsticks(torch, q, kp, vp, tables, info)
        chk.timed(label, [lambda: KA.paged_prefill_attention(
                      q, kp, vp, tables, info, block_q=bq)],
                  [lambda: R.packed_prefill_attention_ref(q, kp, vp, tables, info)],
                  libs, nbytes, flops, weight=0)

    # f32 at the four cases of tests/test_packed_prefill.py
    h, hkv, d, bs, nbt, nb = 4, 2, 16, 8, 6, 32
    for seg_lens, kv_starts, bq in [((5, 9), (7, 0), None),
                                    ((3, 4, 2), (0, 11, 5), 4),
                                    ((6, 1, 8, 3), (2, 0, 9, 0), 8),
                                    ((11,), (13,), 4)]:
        c = sum(seg_lens) + 2
        q, kp, vp, tables, info = _prefill_case(
            torch, g, c, h, hkv, d, bs, nbt, nb, list(zip(seg_lens, kv_starts)),
            torch.float32)
        real = _real_rows(info)
        chk.compare(f"f32 segs {seg_lens} vs plain",
                    KA.paged_prefill_attention(q, kp, vp, tables, info,
                                               block_q=bq)[0, real],
                    R.packed_prefill_attention_ref(q, kp, vp, tables, info)[0, real],
                    ATT_TOL_F32, "same algorithm, f32 summation order")
    # other head geometries (D = 256 in f32 takes > 48 KB of shared memory)
    for h, hkv, d, bs in [(8, 8, 64, 8), (32, 4, 128, 32), (16, 4, 256, 16)]:
        segs = [(7, 0), (12, 13), (0, 0)]
        q, kp, vp, tables, info = _prefill_case(torch, g, 21, h, hkv, d, bs, 4,
                                                16, segs, torch.float32)
        real = _real_rows(info)
        chk.compare(f"f32 H={h} Hkv={hkv} D={d} bs={bs} vs plain",
                    KA.paged_prefill_attention(q, kp, vp, tables, info)[0, real],
                    R.packed_prefill_attention_ref(q, kp, vp, tables, info)[0, real],
                    ATT_TOL_F32, "same algorithm, f32 summation order")


def _bitwise(chk, label, a, b):
    """Two calls on the same inputs must give the same bits (the split
    kernels combine their partials in split order, with no float atomics)."""
    torch = sys.modules["torch"]
    bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
    same = torch.equal(a.view(bits), b.view(bits))
    log(f"  {chk.name} {label}: two calls bitwise equal {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{chk.name} {label}: two calls differ")


def serving_gemms(cfg):
    """(role, K, N, activation) of the serving path's five GEMM shapes."""
    d, hd = cfg.d_model, cfg.hd
    return [("qkv_proj", d, cfg.n_heads * hd, None),
            ("qkv_proj(k,v)", d, cfg.n_kv_heads * hd, None),
            ("mlp_up", d, cfg.d_ff, "silu"),
            ("mlp_down", cfg.d_ff, d, None),
            ("lm_head", d, cfg.vocab, None)]


def moe_gemms(cfg):
    """(role, K, N, activation) of the MoE serving path's GEMM shapes: the
    four projections of MHA attention are one shape, and the MLP roles run
    the shared expert, n_shared_experts x d_expert wide (the routed
    experts are batched matmuls, not the GEMM)."""
    d, hd, wide = cfg.d_model, cfg.hd, cfg.n_shared_experts * cfg.d_expert
    return [("qkv_proj", d, cfg.n_heads * hd, None),
            ("shared mlp_up", d, wide, "silu"),
            ("shared mlp_down", wide, d, None),
            ("lm_head", d, cfg.vocab, None)]


def _matmul_serving_shapes(torch, chk, g, name, gemms):
    """The GEMM at a model's serving shapes (bf16, M = 8 and 256) against
    the plain version, twice bitwise, timed beside torch.matmul."""
    from repro_torch.kernels import matmul as KM
    from repro_torch.kernels import ref as R

    dev = DEVICE
    for m in (8, 256):
        for role, k, n, act in gemms:
            x = (torch.randn((m, k), generator=g, device=dev)).to(torch.bfloat16)
            w = (torch.randn((k, n), generator=g, device=dev)
                 / math.sqrt(k)).to(torch.bfloat16)
            geo = KM.gemm_geometry(m, n, k, x.dtype)
            before = KM.matmul_fused.launches
            out = KM.matmul_fused(x, w, None, act)
            if KM.matmul_fused.launches != before + 1:
                raise AssertionError("matmul_fused: one launch per call")
            # split-K where the column tiles alone leave SMs idle (every
            # shape but lm_head until starcoder2's mlp_up, 192 tiles)
            if (m == 8 and role != "lm_head" and -(-n // geo.bn) < H100_SMS
                    and geo.split < 2):
                raise AssertionError(f"{role} M=8: no split-K ({geo})")
            want = R.matmul_ref(x, w, None, act)
            tol = MM_RTOL_BF16 * max(1.0, want.float().abs().max().item())
            label = f"{name}{role} M={m} K={k} N={n} act={act} bf16"
            chk.err = max(chk.err, chk.compare(
                f"{label} vs plain ({geo.ctas(m, n)} CTAs, bm {geo.bm}, "
                f"split {geo.split})", out, want,
                tol, "f32 summation order, one bf16 rounding"))
            _bitwise(chk, label, out, KM.matmul_fused(x, w, None, act))
            ws = [w] + [w.clone() for _ in range(copies_for(w.numel() * 2) - 1)]
            kfns = [lambda wq=wq: KM.matmul_fused(x, wq, None, act) for wq in ws]
            pfns = [lambda wq=wq: R.matmul_ref(x, wq, None, act) for wq in ws]
            if act == "silu":
                lfns = [lambda wq=wq: torch.nn.functional.silu(torch.matmul(x, wq))
                        for wq in ws]
            else:
                lfns = [lambda wq=wq: torch.matmul(x, wq) for wq in ws]
            nbytes = 2 * (m * k + k * n + m * n)
            chk.timed(f"{label} (library: torch.matmul + activation)",
                      kfns, pfns, lfns, nbytes, 2 * m * n * k, device=True)


def check_matmul(torch, chk, cfg):
    from repro_torch.kernels import matmul as KM
    from repro_torch.kernels import ref as R

    dev = DEVICE
    g = torch.Generator(device=dev).manual_seed(3)
    _matmul_serving_shapes(torch, chk, g, "", serving_gemms(cfg))
    # f32 at small ragged and aligned shapes (the JAX kernel tests' scale)
    for (m, k, n) in ((37, 70, 53), (64, 128, 256)):
        for act in (None, "silu", "gelu"):
            x = torch.randn((m, k), generator=g, device=dev)
            w = torch.randn((k, n), generator=g, device=dev)
            b = torch.randn((n,), generator=g, device=dev)
            out = KM.matmul_fused(x, w, b, act)
            want = R.matmul_ref(x, w, b, act)
            tol = MM_RTOL_F32 * max(1.0, want.abs().max().item())
            chk.compare(f"f32 M={m} K={k} N={n} act={act} bias vs plain",
                        out, want, tol, "f32 summation order")
    # ResNet-18's fc, the GEMM's launch on the WPK-only plan: M=1 f32 + bias
    m, k, n = 1, 512, 1000
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev) / math.sqrt(k)
    b = torch.randn((n,), generator=g, device=dev) * 0.1
    want = R.matmul_ref(x, w, b, None)
    out = KM.matmul_fused(x, w, b, None)
    chk.err = max(chk.err, chk.compare(
        f"resnet18 fc M={m} K={k} N={n} act=None f32 bias vs plain (split "
        f"{KM.gemm_geometry(m, n, k, x.dtype).split})", out, want,
        MM_RTOL_F32 * max(1.0, want.abs().max().item()), "f32 summation order"))
    _bitwise(chk, "resnet18 fc f32", out, KM.matmul_fused(x, w, b, None))
    ws = [w] + [w.clone() for _ in range(copies_for(w.numel() * 4) - 1)]
    chk.timed(f"resnet18 fc M={m} K={k} N={n} act=None f32 bias "
              "(library: torch.addmm)",
              [lambda wq=wq: KM.matmul_fused(x, wq, b, None) for wq in ws],
              [lambda wq=wq: R.matmul_ref(x, wq, b, None) for wq in ws],
              [lambda wq=wq: torch.addmm(b, x, wq) for wq in ws],
              4 * (m * k + k * n + n + m * n), 2 * m * n * k, F32_FLOPS, device=True)
    # bf16 edges the serving shapes never reach: K and N not multiples of 8
    # (element-wise tile loads), bias, and M between the two tile heights;
    # then split-K at its edges: K not a multiple of S x BK (a short last
    # split, a ragged last k-step), N ragged, M = 17 and 255 (ragged
    # 64-row tiles), bias + gelu after the ordered sum
    for (m, k, n) in ((37, 70, 53), (20, 2048, 1000), (8, 2056, 1000),
                      (17, 2048, 2048), (255, 2000, 1000), (8, 6144, 2047),
                      (1, 1000, 260), (255, 6200, 1020)):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device=dev) / math.sqrt(k)
             ).to(torch.bfloat16)
        b = torch.randn((n,), generator=g, device=dev).to(torch.bfloat16)
        geo = KM.gemm_geometry(m, n, k, x.dtype)
        want = R.matmul_ref(x, w, b, "gelu")
        tol = MM_RTOL_BF16 * max(1.0, want.float().abs().max().item())
        out = KM.matmul_fused(x, w, b, "gelu")
        label = (f"bf16 M={m} K={k} N={n} act=gelu bias (bm {geo.bm}, split "
                 f"{geo.split}, K % (S x BK) = {k % (geo.split * geo.bk)})")
        chk.compare(f"{label} vs plain", out, want, tol,
                    "f32 summation order, one bf16 rounding")
        _bitwise(chk, label, out, KM.matmul_fused(x, w, b, "gelu"))


def ssm_gemms(cfg):
    """(lane, role, M, K, N) of the ssm serving path's six GEMM shapes: the
    chunk lane's in_proj / out_proj at M = chunk width and its lm_head at
    M = 1 (the segment's last row), the decode lane's three at M = slots."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    proj = 2 * d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim
    c, b = SERVE_RUNTIME["chunk_tokens"], SERVE_RUNTIME["max_slots"]
    return [("chunk", "in_proj", c, d, proj), ("chunk", "out_proj", c, d_in, d),
            ("chunk", "lm_head", 1, d, cfg.vocab),
            ("decode", "in_proj", b, d, proj), ("decode", "out_proj", b, d_in, d),
            ("decode", "lm_head", b, d, cfg.vocab)]


def check_matmul_ssm(torch, chk, cfg):
    """The GEMM at mamba2-2.7b's six serving shapes (bf16, no activation):
    N = 10,576 (82.6 tiles of 128) and 50,280 (392.8 tiles, not a multiple
    of 16) are ragged, and split-K runs over ragged tiles at M = 8."""
    g = torch.Generator(device=DEVICE).manual_seed(12)
    _matmul_lane_shapes(torch, chk, g, "mamba2 ", ssm_gemms(cfg))


def _matmul_lane_shapes(torch, chk, g, name, shapes):
    """The GEMM at (lane, role, M, K, N) shapes (bf16, no activation)
    against the plain version, twice bitwise, timed beside torch.matmul."""
    from repro_torch.kernels import matmul as KM
    from repro_torch.kernels import ref as R

    for lane, role, m, k, n in shapes:
        x = torch.randn((m, k), generator=g, device=DEVICE).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device=DEVICE) / math.sqrt(k)
             ).to(torch.bfloat16)
        geo = KM.gemm_geometry(m, n, k, x.dtype)
        want = R.matmul_ref(x, w, None, None)
        out = KM.matmul_fused(x, w, None, None)
        tol = MM_RTOL_BF16 * max(1.0, want.float().abs().max().item())
        label = (f"{name}{lane} {role} M={m} K={k} N={n} bf16 ({n / geo.bn:.1f} "
                 f"column tiles, {geo.ctas(m, n)} CTAs, bm {geo.bm}, split {geo.split})")
        chk.err = max(chk.err, chk.compare(f"{label} vs plain", out, want, tol,
                                           "f32 summation order, one bf16 rounding"))
        _bitwise(chk, label, out, KM.matmul_fused(x, w, None, None))
        ws = [w] + [w.clone() for _ in range(copies_for(w.numel() * 2) - 1)]
        chk.timed(f"{label} (library: torch.matmul)",
                  [lambda wq=wq: KM.matmul_fused(x, wq, None, None) for wq in ws],
                  [lambda wq=wq: R.matmul_ref(x, wq, None, None) for wq in ws],
                  [lambda wq=wq: torch.matmul(x, wq) for wq in ws],
                  2 * (m * k + k * n + m * n), 2 * m * n * k, device=True)


def check_matmul_models(torch, chk, granite, moe):
    """The GEMM at granite-3-8b's five serving shapes (N = 49,155 at
    lm_head: not a multiple of 8, so the 16-byte cp.async loads of w and
    the vector stores give way to the scalar path) and at qwen2-moe's
    four (the shared expert's 2048 -> 5632 -> 2048, lm_head N 151,936);
    then the odd-N path split: granite's lm_head at M = 8 and 256 at every
    (tile_m, split_k) with split_k > 1 the template admits, against the
    plain version, each call twice and bitwise equal."""
    from repro_torch.core import TEMPLATES, OpDesc
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as R

    g = torch.Generator(device=DEVICE).manual_seed(14)
    _matmul_serving_shapes(torch, chk, g, "granite ", serving_gemms(granite))
    _matmul_serving_shapes(torch, chk, g, "qwen2-moe ", moe_gemms(moe))
    tmpl = TEMPLATES["pallas_matmul"]
    k, n = granite.d_model, granite.vocab
    for m in (8, 256):
        x = torch.randn((m, k), generator=g, device=DEVICE).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device=DEVICE) / math.sqrt(k)
             ).to(torch.bfloat16)
        want = R.matmul_ref(x, w, None, None)
        tol = MM_RTOL_BF16 * max(1.0, want.float().abs().max().item())
        splits = [c for c in tmpl.enumerate_configs(OpDesc.matmul(m, n, k))
                  if c["split_k"] > 1]
        if not splits:
            raise AssertionError(f"granite lm_head M={m}: no split pair admitted")
        for cfg in splits:
            label = (f"granite lm_head M={m} K={k} N={n} (N % 8 = {n % 8}) bf16 "
                     f"tile_m {cfg['tile_m']} split_k {cfg['split_k']}")
            out = kops.matmul(x, w, config=cfg)
            chk.err = max(chk.err, chk.compare(f"{label} vs plain", out, want, tol,
                                               "f32 summation order, one bf16 rounding"))
            _bitwise(chk, label, out, kops.matmul(x, w, config=cfg))


def check_matmul_vlm(torch, chk, cfg):
    """The GEMM at qwen2-vl-2b's five serving shapes (qkv 1536 -> 1536 /
    256, mlp_up 1536 -> 8960, mlp_down 8960 -> 1536, lm_head 1536 ->
    151,936) at M = 8 and 256, as `check_matmul_models` holds granite's."""
    g = torch.Generator(device=DEVICE).manual_seed(15)
    _matmul_serving_shapes(torch, chk, g, "qwen2-vl ", serving_gemms(cfg))


def check_matmul_large(torch, chk, internlm2, starcoder2):
    """The GEMM at internlm2-20b's and starcoder2-15b's five serving shapes
    (d_model 6144; qkv N 6144, k / v N 1024 and 512, mlp_up N 16384 /
    24576, mlp_down K 16384 / 24576, lm_head N 92544 / 49152, both
    multiples of 8, so the vector body runs) at M = 8 and 256, as
    `check_matmul_models` holds granite's."""
    g = torch.Generator(device=DEVICE).manual_seed(16)
    _matmul_serving_shapes(torch, chk, g, "internlm2 ", serving_gemms(internlm2))
    _matmul_serving_shapes(torch, chk, g, "starcoder2 ", serving_gemms(starcoder2))


# Tensor-parallel serving's rank shapes (phase 21): what one rank of a
# tp-wide model axis launches for qwen3-1.7b, from the port's own layout
# (`serve_rules` without a plan, `models.attention.tp_kv_heads`): paged
# decode and prefill at tp = 2 (H 8 / Hkv 4), 4 (H 4 / Hkv 2) and 16 (H 1;
# kv_heads do not divide 16, so the rank holds the one KV head its query
# head reads), the GEMM at tp = 2 and 4 (N / tp for qkv, mlp_up and
# lm_head, K / tp for mlp_down).
TP_KERNEL_WIDTHS = (2, 4, 16)
TP_GEMM_WIDTHS = (2, 4)


class _AxisSizes:
    """A (1, tp) mesh's axis sizes: all `serve_rules` and the layout race
    read of a mesh."""

    def __init__(self, model):
        self.shape = {"data": 1, "model": model}


def tp_rank_layout(cfg, tp, rank=None):
    """(rules, local query heads, (first, count) of the local KV heads) of
    rank `rank` (default: the last) of a tp-wide model axis, no plan."""
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.models.attention import tp_kv_heads
    from repro_torch.serve.router import PlanRouter

    rules = PlanRouter(None).serve_rules(DEFAULT_RULES, _AxisSizes(tp), cfg)
    rank = tp - 1 if rank is None else rank
    h = cfg.n_heads // tp if rules.lookup("heads") == "model" else cfg.n_heads
    return rules, h, tp_kv_heads(cfg, rules, rank, tp)


def tp_gemms(cfg, tp):
    """`serving_gemms` at one rank's shard shapes."""
    rules, h, (_, hkv) = tp_rank_layout(cfg, tp)
    split = lambda axis, n: n // tp if rules.lookup(axis) == "model" else n  # noqa: E731
    return serving_gemms(dataclasses.replace(
        cfg, n_heads=h, n_kv_heads=hkv, d_ff=split("ffn", cfg.d_ff),
        vocab=split("vocab", cfg.vocab)))


def check_tp_shapes(torch, checks, cfg, block_q):
    """Paged decode, paged prefill and the GEMM at qwen3-1.7b's rank shapes
    (see TP_KERNEL_WIDTHS), each against its plain version, twice bitwise,
    timed beside the library call."""
    g = torch.Generator(device=DEVICE).manual_seed(17)
    for tp in TP_KERNEL_WIDTHS:
        rules, h, (first, hkv) = tp_rank_layout(cfg, tp)
        label = f"qwen3-1.7b tp={tp} rank {tp - 1}"
        if rules.lookup("kv_heads") is None:
            label += f" (kv_heads replicated: its one query head reads KV head {first})"
        _decode_serving_shape(torch, checks[0], g, label, h, hkv)
        _prefill_serving_shape(torch, checks[1], g, label, h, hkv, block_q)
    for tp in TP_GEMM_WIDTHS:
        _matmul_serving_shapes(torch, checks[2], g, f"qwen3 tp={tp} ", tp_gemms(cfg, tp))


# Tensor-parallel serving of the other ContinuousEngine families (phase
# 22): paged decode and prefill at the ranks' heads of qwen2-moe-a2.7b
# (H = Hkv 8 / 4, G = 1) and qwen2-vl-2b (H 6 / 3 over 1 KV head: at tp = 4
# its 2 KV heads do not divide and a rank keeps the one its query heads
# read), and the GEMM at the three models' shard shapes for tp = 2 / 4:
# mamba2's head-aligned in_proj (N = 2 d_in / tp + 2n + nh / tp) and its
# out_proj's K slice, the MoE's attention and shared-expert shards, the
# vlm's, and each vocabulary slice of lm_head.
TP_FAMILY_ARCHS = ("qwen2-vl-2b", "mamba2-2.7b", "qwen2-moe-a2.7b")
# phase 22 (b)'s ranks serve each model at full width and this depth (a
# seventh or an eighth of 28 / 64 / 24), against a tp = 1 eager run and
# replay at it
TP_FAMILY_CHILD_LAYERS = {"qwen2-vl-2b": 4, "mamba2-2.7b": 8, "qwen2-moe-a2.7b": 4}


def tp_family_cfg(arch):
    """Phase 22 (b)'s configuration of `arch`: full width, the cut depth."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=TP_FAMILY_CHILD_LAYERS[arch])


def tp_family_gemms(cfg, tp):
    """The GEMM shapes one rank of a tp-wide model axis runs, no plan: the
    ssm family's (lane, role, M, K, N) or a decoder's (role, K, N,
    activation)."""
    if cfg.family == "ssm":
        d = cfg.d_model
        d_in = cfg.ssm_expand * d // tp
        proj = 2 * d_in + 2 * cfg.ssm_state + cfg.ssm_expand * d // cfg.ssm_head_dim // tp
        c, b = SERVE_RUNTIME["chunk_tokens"], SERVE_RUNTIME["max_slots"]
        v = cfg.vocab // tp
        return [("chunk", "in_proj", c, d, proj), ("chunk", "out_proj", c, d_in, d),
                ("chunk", "lm_head", 1, d, v), ("decode", "in_proj", b, d, proj),
                ("decode", "out_proj", b, d_in, d), ("decode", "lm_head", b, d, v)]
    if cfg.family == "moe":
        rules, h, _ = tp_rank_layout(cfg, tp)
        split = lambda axis, n: n // tp if rules.lookup(axis) == "model" else n  # noqa: E731
        return moe_gemms(dataclasses.replace(
            cfg, n_heads=h, d_expert=split("ffn", cfg.d_expert),
            vocab=split("vocab", cfg.vocab)))
    return tp_gemms(cfg, tp)


def check_tp_family_shapes(torch, checks, block_q):
    """Rows 1-3 at phase 22's rank shapes (see TP_FAMILY_ARCHS), each
    against its plain version, twice bitwise, timed beside the library
    call."""
    from repro_torch.configs import get_config

    g = torch.Generator(device=DEVICE).manual_seed(22)
    for arch in TP_FAMILY_ARCHS:
        cfg = get_config(arch)
        for tp in TP_GEMM_WIDTHS:
            tag = f"{arch} tp={tp} rank {tp - 1}"
            if cfg.family == "ssm":
                _matmul_lane_shapes(torch, checks[2], g, f"{tag} ", tp_family_gemms(cfg, tp))
                continue
            rules, h, (first, hkv) = tp_rank_layout(cfg, tp)
            label = tag
            if rules.lookup("kv_heads") is None:
                label += f" (kv_heads replicated: its query heads read KV head {first})"
            _decode_serving_shape(torch, checks[0], g, label, h, hkv)
            _prefill_serving_shape(torch, checks[1], g, label, h, hkv, block_q)
            _matmul_serving_shapes(torch, checks[2], g, f"{tag} ", tp_family_gemms(cfg, tp))


# The GEMM's tuned knobs (tile_m, split_k).  KNOB_CHECKS: the shapes at
# which every pair the template admits runs against the plain version
# (qwen3's lm_head at M = 256: the largest N, splits capped by the
# partials; qkv at M = 8: every split of the ladder; mamba2's chunk-lane
# in_proj: ragged N at M = 256).  Then at the 16 serving shapes, the
# default geometry, the fastest admitted pair (a device-time sweep over
# them all) and torch.matmul, each by device time (CUDA-graph replay).
KNOB_CHECKS = (("qwen3", "lm_head", 256), ("qwen3", "qkv_proj", 8),
               ("mamba2", "in_proj", 256))
KNOB_SWEEP_CALLS, KNOB_SWEEP_REPLAYS = 10, 2


def knob_gemms(qcfg, scfg):
    """(model, role, M, K, N, activation) of the 16 serving GEMM shapes:
    qwen3-1.7b's five roles at M = 8 and 256, mamba2-2.7b's six."""
    out = [("qwen3", role, m, k, n, act) for m in (8, 256)
           for role, k, n, act in serving_gemms(qcfg)]
    return out + [("mamba2", f"{lane} {role}", m, k, n, None)
                  for lane, role, m, k, n in ssm_gemms(scfg)]


def check_matmul_knobs(torch, chk, qcfg, scfg):
    """The GEMM at every (tile_m, split_k) its template admits (see
    KNOB_CHECKS), then default vs best-tuned vs torch.matmul device times
    at the 16 serving shapes.  -> the GEMM's launches here."""
    from repro_torch.core import TEMPLATES, OpDesc
    from repro_torch.kernels import matmul as KM
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as R

    tmpl = TEMPLATES["pallas_matmul"]
    g = torch.Generator(device=DEVICE).manual_seed(13)
    KM.matmul_fused.launches = 0
    t0 = time.perf_counter()
    summary = []
    for model, role, m, k, n, act in knob_gemms(qcfg, scfg):
        x = torch.randn((m, k), generator=g, device=DEVICE).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device=DEVICE) / math.sqrt(k)
             ).to(torch.bfloat16)
        want = R.matmul_ref(x, w, None, act)
        tol = MM_RTOL_BF16 * max(1.0, want.float().abs().max().item())
        configs = list(tmpl.enumerate_configs(OpDesc.matmul(m, n, k)))
        default = KM.gemm_geometry(m, n, k, torch.bfloat16)
        label = f"{model} {role} M={m} K={k} N={n} bf16"
        checked = any(model == km and role.endswith(kr) and m == kmm
                      for km, kr, kmm in KNOB_CHECKS)
        for cfg in configs if checked else ():
            out = kops.matmul(x, w, config=cfg, activation=act)
            chk.err = max(chk.err, chk.compare(
                f"{label} tile_m {cfg['tile_m']} split_k {cfg['split_k']} vs plain",
                out, want, tol, "f32 summation order, one bf16 rounding"))
            if cfg["split_k"] > 1:
                _bitwise(chk, f"{label} {cfg}", out,
                         kops.matmul(x, w, config=cfg, activation=act))
        ws = [w] + [w.clone() for _ in range(copies_for(w.numel() * 2) - 1)]

        def fns(cfg):
            return [lambda wq=wq: kops.matmul(x, wq, config=cfg, activation=act)
                    for wq in ws]

        sweep = {(c["tile_m"], c["split_k"]): graph_ms(
            torch, fns(c), calls=KNOB_SWEEP_CALLS, replays=KNOB_SWEEP_REPLAYS)
            for c in configs}
        best = min(sweep, key=sweep.get)
        best_cfg = {"tile_m": best[0], "split_k": best[1]}
        chk.err = max(chk.err, chk.compare(
            f"{label} best pair {best_cfg} vs plain",
            kops.matmul(x, w, config=best_cfg, activation=act), want, tol,
            "f32 summation order, one bf16 rounding"))
        if act == "silu":
            lib = [lambda wq=wq: torch.nn.functional.silu(torch.matmul(x, wq)) for wq in ws]
        else:
            lib = [lambda wq=wq: torch.matmul(x, wq) for wq in ws]
        # in turns: default, best, library, library, best, default
        lanes = {"default": fns(None), "best": fns(best_cfg), "library": lib}
        times = {lane: [] for lane in lanes}
        for lane in ("default", "best", "library", "library", "best", "default"):
            times[lane].append(graph_ms(torch, lanes[lane]))
        t = {lane: min(v) for lane, v in times.items()}
        summary.append((label, m, t))
        chk.shapes.append({"shape": f"{label} (knob sweep)", "weight": 0,
                           "default": [default.bm, default.split],
                           "best": list(best), "pairs": len(configs),
                           "default_device_ms": t["default"],
                           "best_device_ms": t["best"],
                           "library_device_ms": t["library"]})
        log(f"  matmul_fused {label}: {len(configs)} admitted pairs"
            f"{' (each checked)' if checked else ''}; device ms (CUDA graph): default "
            f"(tile_m {default.bm}, split_k {default.split}) {t['default']:.4f}, best "
            f"(tile_m {best[0]}, split_k {best[1]}) {t['best']:.4f}, torch.matmul"
            f"{' + silu' if act == 'silu' else ''} {t['library']:.4f}; default / library "
            f"{t['default'] / t['library']:.2f}x, best / library "
            f"{t['best'] / t['library']:.2f}x; sweep "
            + " ".join(f"{a}/{b}:{v:.4f}" for (a, b), v in sorted(sweep.items())))
    for m in (8, 256):
        rows = [t for _, mm, t in summary if (mm == m or (m == 8 and mm == 1))]
        log(f"  matmul_fused knob sweep, M {'<= 8' if m == 8 else '= 256'} "
            f"({len(rows)} shapes): sum of device ms default "
            f"{sum(t['default'] for t in rows):.4f}, best "
            f"{sum(t['best'] for t in rows):.4f}, torch.matmul "
            f"{sum(t['library'] for t in rows):.4f}; per shape best / library "
            f"{[round(t['best'] / t['library'], 2) for t in rows]}")
    launches = KM.matmul_fused.launches
    log(f"  matmul_fused knob checks and sweep: {launches} launches, "
        f"{time.perf_counter() - t0:.1f} s")
    return {"gemm_knob_sweep": {"matmul_fused": launches}}


# Conv and elementwise tolerances.  The conv's plain version has the
# kernel's arithmetic (f32 products of the same inputs, f32 sums, bias and
# activation in f32, one rounding), computed by cuDNN with TF32 off: in f32
# the two differ by summation order over K = Kh·Kw·Cin <= 4608 terms,
# bounded by 5e-5 x max(1, max |ref|); in bf16 by one rounding of the
# output, 1e-2 x max(1, max |ref|) (2^-7 relative).  The elementwise chain
# computes each stage in f32 and rounds after it, as the plain version
# does: f32 results differ only where libm differs (expf / tanhf, a few
# ulps), 1e-5 x max(1, max |ref|); bf16 results by at most a bf16 ulp
# flipped at one stage and carried through the rest of the chain,
# 2e-2 x max(1, max |ref|).
CONV_RTOL_F32 = 5e-5
CONV_RTOL_BF16 = 1e-2
ELT_RTOL_F32 = 1e-5
ELT_RTOL_BF16 = 2e-2
# the sweep of tests/test_kernels.py::test_conv2d_kernel_sweep:
# (k, stride, cin, cout) on a (2, 16, 16, cin) input
CONV_SWEEP = [(1, 1, 8, 16), (3, 1, 16, 32), (3, 2, 16, 32), (5, 2, 4, 8),
              (7, 2, 3, 16)]


def _conv_inputs(torch, g, n, h, w, cin, cout, k, dtype):
    x = torch.randn((n, h, w, cin), generator=g, device=DEVICE).to(dtype)
    wt = (torch.randn((k, k, cin, cout), generator=g, device=DEVICE)
          / math.sqrt(k * k * cin)).to(dtype)
    b = torch.randn((cout,), generator=g, device=DEVICE) * 0.1
    return x, wt, b


def _rel_tol(rtol, want):
    return rtol * max(1.0, want.float().abs().max().item())


def resnet_conv_shapes(batch=1, image=224):
    """[(group name, OpDesc in f32, occurrences in one forward)] of
    ResNet-18's 11 conv groups."""
    from repro_torch.core import optimize_graph, op_desc_of
    from repro_torch.core.schedules import OpDesc
    from repro_torch.models.resnet import conv_groups, resnet18_graph

    gopt = optimize_graph(resnet18_graph(batch=batch, image=image))
    dims = [op_desc_of(gopt, n).dims for n in gopt.nodes if n.op == "fused_conv2d"]
    return [(name, OpDesc.make("conv2d", op.d, "float32"), dims.count(op.dims))
            for name, op in conv_groups(batch, image)]


def _fastest_conv_config(torch, KC, x, w, b, d):
    best = None
    for bn in KC.BN_CHOICES:
        for rb in KC.ROW_BLOCKS:
            if KC.geometry(d["n"], d["h"], d["w"], d["cin"], d["cout"], d["kh"],
                           d["kw"], d["stride"], "SAME", bn, rb) is None:
                continue
            ms = time_ms(torch, [lambda bn=bn, rb=rb: KC.conv2d_direct(
                x, w, b, stride=d["stride"], padding="SAME", bn=bn, row_block=rb,
                activation="relu")], iters=10)
            if best is None or ms < best[0]:
                best = (ms, {"bn": bn, "row_block": rb})
    return best[1]


def _conv_geometry(KC, d, cfg, itemsize=4):
    return KC.geometry(d["n"], d["h"], d["w"], d["cin"], d["cout"], d["kh"], d["kw"],
                       d["stride"], "SAME", cfg["bn"], cfg["row_block"],
                       itemsize=itemsize)


def check_conv2d(torch, chk):
    from repro_torch.kernels import conv2d as KC
    from repro_torch.kernels import ref as R

    F = torch.nn.functional
    g = torch.Generator(device=DEVICE).manual_seed(4)
    # ResNet-18's 11 conv groups at batch 1, f32, bias + relu, each at the
    # (bn, row_block) of least time among all the kernel takes
    # (back-to-back launches; the plan's search in phase 4 times single
    # calls, host included); timed per group, host included and on the
    # device alone, and summed over the 20 convs of a forward
    groups = {}
    for name, op, count in resnet_conv_shapes():
        d = op.d
        x, w, b = _conv_inputs(torch, g, d["n"], d["h"], d["w"], d["cin"],
                               d["cout"], d["kh"], torch.float32)
        groups[name] = (d, x, w, b)
        cfg = _fastest_conv_config(torch, KC, x, w, b, d)
        geo = _conv_geometry(KC, d, cfg)

        def kern(x=x, w=w, d=d, cfg=cfg, b=b):
            return KC.conv2d_direct(x, w, b, stride=d["stride"], padding="SAME",
                                    activation="relu", **cfg)

        out, want = kern(), R.conv2d_ref(x, w, b, d["stride"], "SAME", "relu")
        label = (f"{name} {d['h']}x{d['w']}x{d['cin']} -> {d['cout']} "
                 f"k{d['kh']}/s{d['stride']} bn={cfg['bn']} row_block={cfg['row_block']} "
                 f"(tile {geo.bm}x{cfg['bn']}, {geo.tiles_m * geo.tiles_n} tiles, "
                 f"split {geo.split})")
        chk.err = max(chk.err, chk.compare(
            f"{label} f32 vs plain", out, want, _rel_tol(CONV_RTOL_F32, want),
            "3xTF32 products, f32 summation order"))
        _bitwise(chk, f"{label} f32", out, kern())
        copies = copies_for((x.numel() + w.numel()) * 4)
        ins = [(x, w)] + [(x.clone(), w.clone()) for _ in range(copies - 1)]
        kfns = [lambda x=xi, w=wi, d=d, cfg=cfg: KC.conv2d_direct(
            x, w, b, stride=d["stride"], padding="SAME", activation="relu", **cfg)
            for xi, wi in ins]
        pfns = [lambda x=xi, w=wi, d=d: R.conv2d_ref(x, w, b, d["stride"], "SAME", "relu")
                for xi, wi in ins]
        # library: cuDNN on the same input pre-padded at the TF offsets,
        # channels-last (no layout copy), bias in the call, then relu
        (pt, pb), (pl, pr) = (R.same_pads(d["h"], d["kh"], d["stride"]),
                              R.same_pads(d["w"], d["kw"], d["stride"]))
        lins = [(F.pad(xi.permute(0, 3, 1, 2), (pl, pr, pt, pb)).contiguous(
                    memory_format=torch.channels_last),
                 wi.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2))
                for xi, wi in ins]
        lfns = [lambda x=xi, w=wi, d=d: torch.relu(F.conv2d(x, w, b, stride=d["stride"]))
                for xi, wi in lins]
        nbytes = 4 * (x.numel() + w.numel() + b.numel() + out.numel())
        chk.timed(f"{label} f32 bias+relu (library: F.conv2d via cuDNN, TF32 off, "
                  "pre-padded channels-last input, + relu)",
                  kfns, pfns, lfns, nbytes, op.flops(), F32_FLOPS, weight=count,
                  device=True)
        if name in ("c1", "c3"):      # the stem and a 3x3/s2 group in bf16
            xb, wb = x.bfloat16(), w.bfloat16()
            out = KC.conv2d_direct(xb, wb, b, stride=d["stride"], padding="SAME",
                                   activation="relu", **cfg)
            want = R.conv2d_ref(xb, wb, b, d["stride"], "SAME", "relu")
            chk.err = max(chk.err, chk.compare(
                f"{label} bf16 vs plain", out, want,
                _rel_tol(CONV_RTOL_BF16, want), "one bf16 rounding"))
            _bitwise(chk, f"{label} bf16", out, KC.conv2d_direct(
                xb, wb, b, stride=d["stride"], padding="SAME", activation="relu", **cfg))

    # split-K in f32 and bf16: every (bn, row_block) of the two longest-K
    # groups (K = 2,304 and 4,608) whose geometry splits, twice each
    for name in ("c7", "c10"):
        d, x, w, b = groups[name]
        for dtype, rtol in ((torch.float32, CONV_RTOL_F32), (torch.bfloat16, CONV_RTOL_BF16)):
            xd, wt = x.to(dtype), w.to(dtype)
            want = R.conv2d_ref(xd, wt, b, d["stride"], "SAME", "relu")
            splits = []
            for bn in KC.BN_CHOICES:
                for rb in KC.ROW_BLOCKS:
                    geo = _conv_geometry(KC, d, {"bn": bn, "row_block": rb},
                                         xd.element_size())
                    if geo is None or geo.split < 2:
                        continue
                    run = lambda bn=bn, rb=rb: KC.conv2d_direct(
                        xd, wt, b, stride=d["stride"], padding="SAME", bn=bn,
                        row_block=rb, activation="relu")
                    label = (f"{name} {str(dtype)[6:]} bn={bn} row_block={rb} "
                             f"(tile {geo.bm}x{bn}, split {geo.split})")
                    out = run()
                    chk.compare(f"{label} vs plain", out, want, _rel_tol(rtol, want),
                                "split partials summed in split order")
                    _bitwise(chk, label, out, run())
                    splits.append(geo.split)
            if not splits:
                raise AssertionError(f"conv2d {name}: no configuration splits K")

    # the JAX kernel tests' sweep at every (bn, row_block) the kernel
    # takes, then each activation, VALID padding, a ragged Cout and Cin
    # not a multiple of the k-step (element-wise gathers)
    for k, stride, cin, cout in CONV_SWEEP:
        x, w, b = _conv_inputs(torch, g, 2, 16, 16, cin, cout, k, torch.float32)
        want = R.conv2d_ref(x, w, b, stride, "SAME", "relu")
        tol = _rel_tol(CONV_RTOL_F32, want)
        n_cfg = 0
        for bn in KC.BN_CHOICES:
            for rb in KC.ROW_BLOCKS:
                if KC.geometry(2, 16, 16, cin, cout, k, k, stride, "SAME", bn, rb) is None:
                    continue
                got = KC.conv2d_direct(x, w, b, stride=stride, padding="SAME",
                                       bn=bn, row_block=rb, activation="relu")
                err = (got - want).abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"conv2d sweep k{k}/s{stride} {cin}->{cout} "
                                         f"bn={bn} rb={rb}: error {err} > {tol}")
                n_cfg += 1
        log(f"  {chk.name} sweep k{k}/s{stride} {cin}->{cout} (2,16,16): "
            f"{n_cfg} (bn, row_block) configs within {tol:.1e} (f32 summation order)")
    x, w, b = _conv_inputs(torch, g, 2, 15, 13, 24, 40, 3, torch.float32)
    for act in ("none", "gelu", "silu", "tanh", "sigmoid"):
        for padding, stride in (("SAME", 1), ("VALID", 2)):
            want = R.conv2d_ref(x, w, b, stride, padding, act)
            chk.compare(f"f32 (2,15,13,24)->40 k3/s{stride} {padding} act={act} bn=64 rb=2",
                        KC.conv2d_direct(x, w, b, stride=stride, padding=padding,
                                         bn=64, row_block=2, activation=act),
                        want, _rel_tol(CONV_RTOL_F32, want), "f32 summation order")
    want = R.conv2d_ref(x, w, None)
    chk.compare("f32 no bias, bn=64 over Cout 40",
                KC.conv2d_direct(x, w, None, bn=64, row_block=1), want,
                _rel_tol(CONV_RTOL_F32, want), "f32 summation order")
    for dtype, rtol in ((torch.float32, CONV_RTOL_F32), (torch.bfloat16, CONV_RTOL_BF16)):
        x, w, b = _conv_inputs(torch, g, 2, 12, 12, 64, 10, 3, dtype)
        want = R.conv2d_ref(x, w, b, 1, "SAME", "relu")
        chk.compare(f"{str(dtype)[6:]} (2,12,12,64)->10 k3 (Cout 10: element-wise "
                    "weight loads) bn=32 rb=4",
                    KC.conv2d_direct(x, w, b, bn=32, row_block=4, activation="relu"),
                    want, _rel_tol(rtol, want), "summation order, one rounding")


RESIDUAL_SHAPES = [(1, 64, 56, 56), (1, 128, 28, 28), (1, 256, 14, 14),
                   (1, 512, 7, 7)]
# a shape off the main path where bytes, not launches, set the time: the
# residual add+relu of ResNet-18's first stage at batch 32
STREAM_SHAPE = (32, 64, 56, 56)
ADD_RELU = [{"op": "add"}, {"op": "relu"}]
ALL_OP_CHAINS = [["add", "gelu", "mul", "silu", "sub", "tanh", "div", "sigmoid"],
                 ["identity", "relu", "add", "tanh"]]
# lengths around the kernel's vectors and its 16-byte head: 1..17 and
# 2^k +- 1, whose tails are never a whole vector
EDGE_LENGTHS = list(range(1, 18)) + [2**k + d for k in (10, 16, 20) for d in (-1, 1)]


def _add_relu_inputs(torch, g, shape, dtype, copies):
    x = torch.randn(shape, generator=g, device=DEVICE).to(dtype)
    e = torch.randn(shape, generator=g, device=DEVICE).to(dtype)
    return [(x, e)] + [(x.clone(), e.clone()) for _ in range(copies - 1)]


def time_fused(torch, chk):
    """Device times of the add+relu chain through `fused_elementwise`'s
    public call alone, so that they can be taken of another version of the
    kernel too: the residual shapes (weight 2: each runs twice a forward),
    each beside the chain the engine ran before on ref_ops (torch.add, then
    relu: two kernels), and STREAM_SHAPE in f32 and bf16 (weight 0).
    Inputs rotate over `copies_for` copies so that L2 does not serve the
    reads where they exceed it.  Returns {(shape, dtype): inputs}."""
    from repro_torch.core import ref_ops
    from repro_torch.kernels import fused as KF
    from repro_torch.kernels import ref as R

    g = torch.Generator(device=DEVICE).manual_seed(5)
    cases = {}
    for shape, dtype, weight in ([(s, torch.float32, 2) for s in RESIDUAL_SHAPES]
                                 + [(STREAM_SHAPE, torch.float32, 0),
                                    (STREAM_SHAPE, torch.bfloat16, 0)]):
        n = math.prod(shape)
        size = torch.empty((), dtype=dtype).element_size()
        ins = _add_relu_inputs(torch, g, shape, dtype, copies_for(2 * size * n))
        kfns = [lambda x=x, e=e: KF.fused_elementwise(x, ADD_RELU, [e]) for x, e in ins]
        pfns = [lambda x=x, e=e: R.fused_elementwise_ref(x, ADD_RELU, [e]) for x, e in ins]
        chk.timed(f"add+relu {shape} {str(dtype)[6:]} (no single library call)",
                  kfns, pfns, None, 3 * size * n, 2 * n,
                  F32_FLOPS if dtype == torch.float32 else BF16_FLOPS,
                  weight=weight, device=True)
        rec = chk.shapes[-1]
        if weight:
            vendor = graph_ms(torch, [
                lambda x=x, e=e: ref_ops.fused_elementwise([x, e], {"chain": ADD_RELU})
                for x, e in ins])
            rec["vendor_chain_device_ms"] = vendor
            log(f"  {chk.name} add+relu {shape}: device ms kernel {rec['device_ms']:.4f}, "
                f"the engine's chain before (ref_ops: add, relu) {vendor:.4f}")
        else:
            log(f"  {chk.name} add+relu {shape} {str(dtype)[6:]}: device "
                f"{rec['device_ms']:.4f} ms = {rec['bound_ms'] / rec['device_ms']:.1%} "
                f"of the {rec['bound_ms']:.4f} ms bound "
                f"({3 * size * n / rec['device_ms'] / 1e9:.2f} TB/s)")
        cases[shape, dtype] = ins
    return cases


def _floor_fn():
    """The kernel library's empty launch (`fused_elementwise_floor`)."""
    import ctypes

    from repro_torch.kernels import build

    fn = ctypes.CDLL(str(build.lib_path("fused_elementwise"))).fused_elementwise_floor
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_fused(torch, chk):
    from repro_torch.kernels import build
    from repro_torch.kernels import fused as KF
    from repro_torch.kernels import ref as R

    g = torch.Generator(device=DEVICE).manual_seed(5)
    for shape in RESIDUAL_SHAPES:
        x = torch.randn(shape, generator=g, device=DEVICE)
        e = torch.randn(shape, generator=g, device=DEVICE)
        out, want = KF.fused_elementwise(x, ADD_RELU, [e]), R.fused_elementwise_ref(x, ADD_RELU, [e])
        chk.err = max(chk.err, chk.compare(
            f"residual add+relu {shape} f32 vs plain", out, want,
            _rel_tol(ELT_RTOL_F32, want), "same f32 ops"))
    cases = time_fused(torch, chk)
    # the floor: an empty launch of each residual shape's geometry, replayed
    floor = _floor_fn()
    for rec, shape in zip(chk.shapes, RESIDUAL_SHAPES):
        geo = KF.geometry(math.prod(shape), 4, 0)
        rec["floor_device_ms"] = graph_ms(torch, [lambda geo=geo: build.check(floor(
            geo.threads, geo.blocks, torch.cuda.current_stream().cuda_stream),
            "fused_elementwise_floor")])
        log(f"  {chk.name} add+relu {shape}: geometry {geo}; device ms kernel "
            f"{rec['device_ms']:.4f}, empty launch of that geometry "
            f"{rec['floor_device_ms']:.4f}, bound {rec['bound_ms']:.4f}")
    # the streaming geometry: unroll x resident blocks per SM at STREAM_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        ins = cases[STREAM_SHAPE, dtype]
        size, n = ins[0][0].element_size(), ins[0][0].numel()
        row = []
        for unroll in (1, 2, 4):
            for resident in (2, 4, 8):
                geo = KF.geometry(n, size, 0, unroll=unroll, resident=resident)
                ms = graph_ms(torch, [lambda x=x, e=e, geo=geo: KF.fused_elementwise(
                    x, ADD_RELU, [e], geo=geo) for x, e in ins])
                row.append(f"u{unroll} r{resident} {ms:.4f}")
        log(f"  {chk.name} add+relu {STREAM_SHAPE} {str(dtype)[6:]} streaming "
            f"geometry, device ms by unroll / resident blocks per SM: " + ", ".join(row))
    _check_fused_edges(torch, chk, g)
    # every op, and a length that is not a multiple of 128 (3 x 50 x 33)
    for dtype, rtol in ((torch.float32, ELT_RTOL_F32), (torch.bfloat16, ELT_RTOL_BF16)):
        for ops in ALL_OP_CHAINS:
            n_extra = sum(op in KF.BINARY_CODES for op in ops)
            x = torch.randn((3, 50, 33), generator=g, device=DEVICE).to(dtype)
            extras = [(torch.rand((3, 50, 33), generator=g, device=DEVICE) + 0.5).to(dtype)
                      for _ in range(n_extra)]
            chain = [{"op": op} for op in ops]
            want = R.fused_elementwise_ref(x, chain, extras)
            chk.err = max(chk.err, chk.compare(
                f"{'+'.join(ops)} (3,50,33) {str(dtype)[6:]} vs plain",
                KF.fused_elementwise(x, chain, extras), want,
                _rel_tol(rtol, want),
                "libm ulps" if dtype == torch.float32 else "a bf16 ulp carried"))


def _check_fused_edges(torch, chk, g):
    """Lengths and alignments at the kernel's edges, and the stages that
    must round as separate ops do."""
    from repro_torch.kernels import fused as KF
    from repro_torch.kernels import ref as R

    generic = [{"op": op} for op in ("mul", "sub", "sigmoid", "add")]
    for dtype, rtol in ((torch.float32, ELT_RTOL_F32), (torch.bfloat16, ELT_RTOL_BF16)):
        worst, heads = 0.0, set()
        for n in EDGE_LENGTHS:
            bufs = [torch.randn(n + 1, generator=g, device=DEVICE).to(dtype) + 2.0
                    for _ in range(3)]
            # aligned; x and extras one element past it (a head of whole
            # elements, then vectors); x alone past it (the scalar body)
            for ox, oe in ((0, 0), (1, 1), (1, 0)):
                x, extras = bufs[0][ox:ox + n], [b[oe:oe + n] for b in bufs[1:]]
                offsets = {t.data_ptr() % 16 for t in [x, *extras]}
                heads.add(KF.geometry(n, x.element_size(), offsets.pop()
                                      if len(offsets) == 1 else None).head)
                got = KF.fused_elementwise(x, ADD_RELU, extras[:1])
                if not torch.equal(got, R.fused_elementwise_ref(x, ADD_RELU, extras[:1])):
                    raise AssertionError(f"{chk.name} add+relu n={n} offsets {ox},{oe} "
                                         f"{dtype}: differs from the plain version")
                want = R.fused_elementwise_ref(x, generic, extras + extras[:1])
                got = KF.fused_elementwise(x, generic, extras + extras[:1])
                err = (got.float() - want.float()).abs().max().item()
                if not err <= _rel_tol(rtol, want):
                    raise AssertionError(f"{chk.name} mul+sub+sigmoid+add n={n} offsets "
                                         f"{ox},{oe} {dtype}: error {err}")
                worst = max(worst, err)
        chk.err = max(chk.err, worst)
        log(f"  {chk.name} {str(dtype)[6:]} n = 1..17, 2^k +- 1 (k = 10, 16, 20), x / "
            "extras at offsets 0/0, 1/1, 1/0 elements (heads "
            f"{sorted(heads)}): add+relu bitwise equal to the plain version; "
            f"mul+sub+sigmoid+add max_abs_err {worst:.3e} (tol {rtol:.0e} x "
            "max(1, max |ref|)) ok")
    # contraction: a mul stage followed by add / sub rounds twice, as two
    # PyTorch ops do (an FMA would round once and differ in the last bit)
    for ops in (["mul", "add"], ["mul", "sub"]):
        chain = [{"op": op} for op in ops]
        for n, off in ((math.prod(RESIDUAL_SHAPES[0]), 0), (2**16 + 1, 1)):
            x, e1, e2 = (torch.randn(n + off, generator=g, device=DEVICE)[off:]
                         for _ in range(3))
            got = KF.fused_elementwise(x, chain, [e1, e2])
            want = R.fused_elementwise_ref(x, chain, [e1, e2])
            if not torch.equal(got, want):
                raise AssertionError(f"{chk.name} {'+'.join(ops)} n={n} f32: "
                                     f"{int((got != want).sum())} elements differ "
                                     "from two separate ops (contracted to an FMA?)")
        log(f"  {chk.name} {'+'.join(ops)} f32 at n = {math.prod(RESIDUAL_SHAPES[0])} "
            f"and {2**16 + 1} (offset 1): bitwise equal to the plain version "
            "(no FMA contraction)")


# The dense attention kernels' plain versions have the kernels' arithmetic
# (f32 Q·Kᵀ, p rounded to the value dtype, f32 P·V) with one global max in
# place of the online one: in bf16 they differ by where p is rounded (before
# or after the rescale by the running max) and by the bf16 output, both
# 2^-9 relative of unit-scale values, within ATT_TOL_F32MATH_BF16; in f32
# by summation order, within ATT_TOL_F32.  The serve graph's attention
# shapes for qwen3-1.7b (16 query heads, 8 KV heads, D = 128):
# (label, B, Sq, Skv), all causal.
SERVE_ATTENTION = [("prefill", 1, 700, 700), ("decode", 8, 1, 1024),
                   ("prefill_chunk", 1, 256, 1024)]
# tests/test_kernels.py::test_attention_sweep (B = 2, D = 64):
# (Sq, Skv, H, Hkv), causal and not, then Sq < Skv and Sq > Skv
ATTENTION_SWEEP = [(256, 256, 4, 4), (256, 256, 4, 2), (200, 200, 4, 1),
                   (128, 384, 2, 2), (32, 300, 4, 2), (40, 17, 4, 2)]
DECODE_LENGTHS = [1, 16, 17, 1000, 1024, 250, 513, 64]


def _causal_pairs(sq, skv):
    """(query, key) pairs the top-left causal mask lets through."""
    return sum(min(i + 1, skv) for i in range(sq))


def _qkv(torch, g, b, sq, skv, h, hkv, d, dtype, scale=1.0):
    mk = lambda *s: (torch.randn(s, generator=g, device=DEVICE) * scale).to(dtype)
    return mk(b, sq, h, d), mk(b, skv, hkv, d), mk(b, skv, hkv, d)


# bf16 shapes where the tensor-core tile's edges are most likely wrong: Sq
# and Skv not multiples of 16, causal Sq < Skv and Sq > Skv (and each also
# non-causal), G = 1 / 2 / 4 / 8, D = 64 / 128 / 256: (B, Sq, Skv, H, Hkv, D)
FLASH_BF16_RAGGED = [(2, 37, 53, 8, 2, 64), (1, 70, 19, 16, 8, 256),
                     (3, 5, 700, 16, 2, 128), (1, 33, 33, 4, 4, 128)]


def check_flash(torch, chk):
    from repro_torch.core.schedules import TEMPLATES, OpDesc
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as R

    F = torch.nn.functional
    g = torch.Generator(device=DEVICE).manual_seed(7)
    h, hkv, d = 16, 8, 128
    for label, b, sq, skv in SERVE_ATTENTION:
        q, k, v = _qkv(torch, g, b, sq, skv, h, hkv, d, torch.bfloat16)
        out = kops.attention(q, k, v, causal=True)
        chk.err = max(chk.err, chk.compare(
            f"{label} B={b} Sq={sq} Skv={skv} bf16 vs plain", out,
            R.attention_ref(q, k, v, True), ATT_TOL_F32MATH_BF16,
            "p rounded at another max, bf16 output"))
        copies = copies_for(2 * k.numel() * 2)
        ins = [(k, v)] + [(k.clone(), v.clone()) for _ in range(copies - 1)]
        kfns = [lambda k=ki, v=vi: kops.attention(q, k, v, causal=True) for ki, vi in ins]
        pfns = [lambda k=ki, v=vi: R.attention_ref(q, k, v, True) for ki, vi in ins]
        qt = q.transpose(1, 2).contiguous()
        lins = [(ki.transpose(1, 2).contiguous(), vi.transpose(1, 2).contiguous())
                for ki, vi in ins]
        lfns = [lambda k=ki, v=vi: F.scaled_dot_product_attention(
            qt, k, v, is_causal=True, enable_gqa=True) for ki, vi in lins]
        pairs = _causal_pairs(sq, skv)
        kv_rows = min(sq, skv)              # rows the top-left mask reaches
        nbytes = 2 * (2 * b * sq * h * d + 2 * b * kv_rows * hkv * d)
        chk.timed(f"{label} B={b} Sq={sq} Skv={skv} H={h} Hkv={hkv} D={d} causal "
                  "(top-left) bf16, default blocks (library: SDPA is_causal, "
                  "enable_gqa, on (B, H, S, D) copies)",
                  kfns, pfns, lfns, nbytes, 4 * b * h * d * pairs, device=True)
    # the JAX sweep in f32 at its config (TPU blocks of 128, clamped)
    for sq, skv, h_, hkv_ in ATTENTION_SWEEP:
        for causal in (True, False):
            q, k, v = _qkv(torch, g, 2, sq, skv, h_, hkv_, 64, torch.float32, 0.3)
            chk.compare(f"f32 Sq={sq} Skv={skv} H={h_} Hkv={hkv_} causal={causal} "
                        "vs plain",
                        kops.attention(q, k, v, causal=causal,
                                       config={"block_q": 128, "block_kv": 128}),
                        R.attention_ref(q, k, v, causal), ATT_TOL_F32,
                        "same algorithm, f32 summation order")
    for b, sq, skv, h_, hkv_, d_ in FLASH_BF16_RAGGED:
        q, k, v = _qkv(torch, g, b, sq, skv, h_, hkv_, d_, torch.bfloat16)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        for causal in (True, False):
            label = (f"bf16 B={b} Sq={sq} Skv={skv} H={h_} Hkv={hkv_} D={d_} "
                     f"causal={causal}")
            chk.err = max(chk.err, chk.compare(
                f"{label} vs plain", kops.attention(q, k, v, causal=causal),
                R.attention_ref(q, k, v, causal), ATT_TOL_F32MATH_BF16,
                "p rounded at another max, bf16 output"))
            pairs = _causal_pairs(sq, skv) if causal else sq * skv
            kv_rows = min(sq, skv) if causal else skv
            chk.timed(f"{label} (library: SDPA on (B, H, S, D) copies)",
                      [lambda: kops.attention(q, k, v, causal=causal)],
                      [lambda: R.attention_ref(q, k, v, causal)],
                      [lambda: F.scaled_dot_product_attention(
                          qt, kt, vt, is_causal=causal, enable_gqa=True)],
                      2 * (2 * b * sq * h_ * d_ + 2 * b * kv_rows * hkv_ * d_),
                      4 * b * h_ * d_ * pairs, weight=0)
    # every tile the template admits, at the race's chunk shape (MHA: the
    # race's inputs carry no Hkv)
    tmpl = TEMPLATES["pallas_attention"]
    op = OpDesc.attention(1, 256, 1024, h, d, label="prefill_chunk.attention")
    tiles = sorted({(c["block_q"], c["block_kv"]) for c in tmpl.enumerate_configs(op)})
    q, k, v = _qkv(torch, g, 1, 256, 1024, h, h, d, torch.bfloat16)
    want = R.attention_ref(q, k, v, True)
    for bq, bkv in tiles:
        got = KA.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
        err = (got.float() - want.float()).abs().max().item()
        if not err <= ATT_TOL_F32MATH_BF16:
            raise AssertionError(f"flash tile ({bq}, {bkv}): error {err}")
    log(f"  {chk.name} every template tile {tiles} at B=1 Sq=256 Skv=1024 "
        f"H=Hkv={h} bf16 within {ATT_TOL_F32MATH_BF16:.0e} of plain")


def check_dense_decode(torch, chk):
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as R

    F = torch.nn.functional
    g = torch.Generator(device=DEVICE).manual_seed(8)
    b, h, hkv, d, s = len(DECODE_LENGTHS), 16, 8, 128, 1024
    nsplit, kps = KA.dense_decode_splits(s)
    if nsplit < 2:
        raise AssertionError(f"dense decode at S={s}: no split-KV")
    q = torch.randn((b, h, d), generator=g, device=DEVICE).to(torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=g, device=DEVICE).to(torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=g, device=DEVICE).to(torch.bfloat16)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=DEVICE)
    out = kops.attention_decode(q, k, v, lengths)
    label = (f"B={b} H={h} Hkv={hkv} D={d} S={s} lengths {DECODE_LENGTHS} bf16 "
             f"(grid {b} x {hkv} x {nsplit} splits of {kps} keys)")
    chk.err = max(chk.err, chk.compare(
        f"{label} vs plain", out, R.dense_decode_attention_ref(q, k, v, lengths),
        ATT_TOL_F32MATH_BF16, "p rounded at another max, bf16 output"))
    _bitwise(chk, "bf16 decode shape", out, kops.attention_decode(q, k, v, lengths))
    copies = copies_for(2 * k.numel() * 2)
    ins = [(k, v)] + [(k.clone(), v.clone()) for _ in range(copies - 1)]
    kfns = [lambda k=ki, v=vi: kops.attention_decode(q, k, v, lengths) for ki, vi in ins]
    pfns = [lambda k=ki, v=vi: R.dense_decode_attention_ref(q, k, v, lengths)
            for ki, vi in ins]
    qs = q[:, :, None, :]
    mask = (torch.arange(s, device=DEVICE)[None, :] < lengths[:, None].long())[:, None, None, :]
    lins = [(ki.transpose(1, 2).contiguous(), vi.transpose(1, 2).contiguous())
            for ki, vi in ins]
    lfns = [lambda k=ki, v=vi: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=mask, enable_gqa=True) for ki, vi in lins]
    rows = sum(DECODE_LENGTHS)
    nbytes = 2 * 2 * q.numel() + 2 * 2 * rows * hkv * d + 4 * b
    chk.timed(f"B={b} H={h} Hkv={hkv} D={d} S={s} bf16 (library: SDPA with a "
              "boolean length mask, enable_gqa, on (B, Hkv, S, D) copies)",
              kfns, pfns, lfns, nbytes, 4 * rows * h * d, device=True)

    # split edges: lengths 0 (zeros), 1, one short of a split edge, at it,
    # one past it, S and past S (taken as S), in bf16 at the decode shape and
    # in f32 at G = 1 / 4 / 8 / 16 and D = 64 / 128 / 256
    edges = [0, 1, kps - 1, kps, kps + 1, 2 * kps + 1, s, s + 5]
    for dtype, h_, hkv_, d_, tol in ((torch.bfloat16, 16, 8, 128, ATT_TOL_F32MATH_BF16),
                                     (torch.float32, 8, 8, 64, ATT_TOL_F32),
                                     (torch.float32, 16, 4, 128, ATT_TOL_F32),
                                     (torch.float32, 16, 2, 256, ATT_TOL_F32),
                                     (torch.float32, 16, 1, 128, ATT_TOL_F32)):
        n_ = len(edges)
        mk = lambda *shape: (torch.randn(shape, generator=g, device=DEVICE) * 0.5).to(dtype)
        q_, k_, v_ = mk(n_, h_, d_), mk(n_, s, hkv_, d_), mk(n_, s, hkv_, d_)
        ln = torch.tensor(edges, dtype=torch.int32, device=DEVICE)
        got = kops.attention_decode(q_, k_, v_, ln)
        want = R.dense_decode_attention_ref(q_.float(), k_.float(), v_.float(), ln)
        label = (f"{str(dtype)[6:]} G={h_ // hkv_} D={d_} S={s} lengths {edges} "
                 f"({nsplit} splits)")
        chk.compare(f"{label} vs f32-math reference", got, want, tol,
                    "split partials combined in split order; length 0 gives zeros")
        if bool(got[0].abs().max() != 0):
            raise AssertionError(f"dense decode {label}: length 0 is not zeros")
        _bitwise(chk, label, got, kops.attention_decode(q_, k_, v_, ln))
    # f32 at tests/test_kernels.py::test_attention_decode_lengths (S = 256:
    # two splits of 128 keys), and a length of 0 (zeros)
    for lens in ([64, 199], [1, 256], [256, 256], [0, 5]):
        q = torch.randn((2, 4, 64), generator=g, device=DEVICE) * 0.3
        k = torch.randn((2, 256, 2, 64), generator=g, device=DEVICE) * 0.3
        v = torch.randn((2, 256, 2, 64), generator=g, device=DEVICE) * 0.3
        ln = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        chk.compare(f"f32 B=2 S=256 H=4 Hkv=2 D=64 lengths {lens} vs plain "
                    "(config block_kv 128, ignored)",
                    kops.attention_decode(q, k, v, ln, config={"block_kv": 128}),
                    R.dense_decode_attention_ref(q, k, v, ln), ATT_TOL_F32,
                    "same algorithm, f32 summation order")


def check_counter_growth(torch, chk):
    """A CUDA graph captured before the split counters grow must replay into
    the buffer it captured: capture dense decode at the decode shape, grow
    its counter buffer with a larger eager launch, churn the allocator, and
    replay — the same bits as before the growth, and the outgrown buffer
    still all zeros."""
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import build

    g = torch.Generator(device=DEVICE).manual_seed(12)
    h, hkv, d = 16, 8, 128

    def case(b, s):
        q = torch.randn((b, h, d), generator=g, device=DEVICE).to(torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, d), generator=g, device=DEVICE)
                .to(torch.bfloat16) for _ in range(2))
        lengths = torch.randint(1, s + 1, (b,), generator=g, device=DEVICE,
                                dtype=torch.int32)
        return q, k, v, lengths

    small = case(8, 1024)
    eager = KA.dense_decode_attention(*small)
    key = ("dense_decode", torch.cuda.current_device())
    old = build._counters[key]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        KA.dense_decode_attention(*small)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = KA.dense_decode_attention(*small)
    graph.replay()
    torch.cuda.synchronize()
    before = static.clone()
    b_big = old.numel() // hkv + 1                 # needs one buffer more than there is
    KA.dense_decode_attention(*case(b_big, 256))
    grown = build._counters[key]
    if grown is old or grown.numel() <= old.numel() or old not in build._superseded:
        raise AssertionError("the larger launch did not grow the counter buffer")
    churn = [torch.full((old.numel(),), 7, dtype=torch.int32, device=DEVICE)
             for _ in range(16)]
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(static.view(torch.int16), before.view(torch.int16)) and \
        torch.equal(before.view(torch.int16), eager.view(torch.int16))
    clean = int(old.abs().sum().item()) == 0 and int(grown.abs().sum().item()) == 0
    log(f"  {chk.name} counter growth: a graph captured at B=8 replayed after a "
        f"B={b_big} eager launch grew the buffer {old.numel()} -> {grown.numel()} "
        f"counters: bitwise equal to the eager call {'ok' if same else 'FAIL'}; "
        f"both buffers zeroed {'ok' if clean else 'FAIL'}")
    del churn
    if not (same and clean):
        raise AssertionError("a graph replay after the counter buffer grew differs")


# The keyed draw (sampling.cu) at the serving lanes' shapes: the decode
# lane's 8 slots and the chunk lane's 4 segments over qwen3-1.7b's
# vocabulary, rows cycling through the bench's mix (greedy, temperature,
# top-k, top-p), each at three seeds and two token indices.  Its integer
# work: threefry's 20 rounds of an add, a rotate (one funnel shift) and a
# xor, and 6 key injections of two adds, then the bits' xor and the
# mantissa's shift and or: 75 32-bit integer instructions per element, at
# the H100's INT32 issue rate (132 SMs x 64 INT32 lanes x 1.98 GHz, the
# Hopper white paper's SM and the SXM part's boost clock).  Its bytes: x in
# f32 and the logits in bf16, 6 per element.
SAMPLE_SHAPES = ((8, "decode lane"), (4, "chunk lane"))
# the ssm path's draws: 8 slots, and one chunk segment
SSM_SAMPLE_SHAPES = ((8, "ssm decode lane"), (1, "ssm chunk lane"))
# the fixed-batch loop's draws (batch 4) and 8 rows, at zamba2's V 32,000
# and whisper's 51,865 (bf16 rows not 16-byte aligned)
FIXED_SAMPLE_SHAPES = ((8, "8 rows"), (4, "fixed-batch loop"))
SAMPLE_SEEDS = (0, 1, 2**31 - 1)
SAMPLE_TOKEN_INDICES = (0, 31)
THREEFRY_INT_OPS = 75
INT32_OPS = 132 * 64 * 1.98e9


def _mixed_sampling(torch, rows):
    sp = torch.zeros((rows, 3), device=DEVICE)
    for i in range(rows):
        sp[i, 0] = (0.0, 0.8, 1.0, 0.9)[i % 4]
        sp[i, 1] = (0, 0, 8, 0)[i % 4]
        sp[i, 2] = (1.0, 1.0, 1.0, 0.85)[i % 4]
    return sp


def check_sampling(torch, chk, vocab, shapes=SAMPLE_SHAPES):
    """The draw kernel against `ref.sample_draw_ref` on the same masked,
    scaled x at each (rows, lane) of `shapes`: tokens equal, and every
    element's f32 uniform (the kernel's debug output) bitwise equal to the
    plain threefry's."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import sampling as KS

    g = torch.Generator(device=DEVICE).manual_seed(11)
    for rows, lane in shapes:
        logits = (torch.randn((rows, vocab), generator=g, device=DEVICE) * 3).bfloat16()
        sp = _mixed_sampling(torch, rows)
        temps = sp[:, 0].contiguous()
        x = logits.float() / torch.clamp(temps, min=KS.TEMP_EPS)[:, None]
        x = KS.mask_top_p(KS.mask_top_k(x, sp[:, 1].long()), sp[:, 2])
        for seed in SAMPLE_SEEDS:
            for index in SAMPLE_TOKEN_INDICES:
                keys = torch.tensor([[seed, 1000 + r, index] for r in range(rows)],
                                    dtype=torch.int32, device=DEVICE)
                u = torch.empty((rows, vocab), device=DEVICE)
                got = KS.sample_draw(x, logits, temps, keys, uniforms=u)
                want = R.sample_draw_ref(x, logits, temps, keys)
                want_u = R.uniform_from_bits(R.random_bits(R.derive_key(keys), vocab))
                same_u = torch.equal(u.view(torch.int32), want_u.view(torch.int32))
                ok = torch.equal(got, want) and same_u
                log(f"  sample_draw ({rows}, {vocab}) {lane} seed {seed} token "
                    f"{index}: tokens {got.tolist()} plain {want.tolist()}, uniforms "
                    f"bitwise {'equal' if same_u else 'DIFFERENT'} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"sample_draw ({rows}, {vocab}) seed {seed} "
                                         f"token {index}: kernel != plain")
                _bitwise(chk, f"({rows}, {vocab}) seed {seed} token {index}", got,
                         KS.sample_draw(x, logits, temps, keys))
        copies = copies_for(6 * rows * vocab)
        ins = [(x, logits)] + [(x.clone(), logits.clone()) for _ in range(copies - 1)]
        kfns = [lambda x=xi, l=li: KS.sample_draw(x, l, temps, keys) for xi, li in ins]
        pfns = [lambda x=xi, l=li: R.sample_draw_ref(x, l, temps, keys) for xi, li in ins]
        chk.timed(f"({rows}, {vocab}) {lane}, logits bf16, {KS.draw_splits(rows, vocab)} "
                  f"CTAs a row (bound: {THREEFRY_INT_OPS} INT32 instructions an "
                  "element at 16.7 T/s; no library call draws threefry)",
                  kfns, pfns, None, 6 * rows * vocab, THREEFRY_INT_OPS * rows * vocab,
                  peak=INT32_OPS, device=True)


# -------------------------------------------------------------- phase 3
# First-token agreement between the kernel lanes and the torch lanes: each
# lane rounds differently at every layer (f32 vs bf16 Q·Kᵀ, the gate's
# activation fused before or after the bf16 rounding), so the bf16 logits
# of the two engines differ by a few bf16 ulps of logits of magnitude ~4
# (ulp 2^-5).  Tokens must agree wherever the reference's top-2 margin
# exceeds FIRST_TOKEN_MARGIN.
FIRST_TOKEN_MARGIN = 0.25
PROMPT_LENS = [32, 700, 64, 512, 96, 384, 128, 256, 48, 640, 160, 448, 200,
               600, 80, 320]


def _spy_first_logits(eng):
    """Record each request's first-token logits (the prefill lane's row)."""
    store = {}
    orig = eng.adapter.dispatch

    def dispatch(params, dec_rids, lengths, last_tok, chunks, *rest):
        out = orig(params, dec_rids, lengths, last_tok, chunks, *rest)
        for i, (req, start, n) in enumerate(chunks):
            if start + n == req.prompt_len:
                # a copy: the logits are the unified program's output
                # buffer, which its next step overwrites
                store[req.rid] = eng.adapter.last_seg_logits[i].to(
                    "cpu", sys.modules["torch"].float32, copy=True)
        return out

    eng.adapter.dispatch = dispatch
    return store


SERVE_RUNTIME = dict(max_slots=8, block_size=16, max_blocks_per_seq=64,
                     chunk_tokens=256, chunk_segments=4, max_new_tokens=32)


def serving_setup(torch, cfg):
    """A decoder at full width and depth (random weights from seed 0, drawn
    on the card one layer at a time by `init_serving`: the f32 model is
    never held) and the 16 prompts every serving run takes, over its
    vocabulary."""
    import numpy as np

    from repro_torch.models import build_model

    model = build_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = model.init_serving(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    moe = (f"{cfg.n_experts} experts top-{cfg.top_k} x {cfg.d_expert}, "
           f"{cfg.n_shared_experts} shared, norm_topk {cfg.norm_topk}, "
           if cfg.family == "moe" else "")
    log(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.hd}, d_ff {cfg.d_ff}, {moe}"
        f"vocab {cfg.vocab}; {n_params / 1e9:.3f} G params "
        f"({sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f} GB) "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    return model, params, prompts


def serve(torch, served, router, label, profile=False, require_packing=True,
          graphs=True, prompts=None, check_schedule=True, samplings=None,
          setup=None, mesh=None, rules=None, **runtime):
    """Serve `prompts` (default: the 16) under `router`, the step programs
    captured in CUDA graphs or (graphs=False) run eagerly; every request
    must finish with its 32 in-vocabulary tokens, the pool must drain,
    `submit()` must capture nothing, each program must hold one signature
    (graphed: captured once, replayed by every later step), and (with
    `check_schedule`) chunked, decode-only and (where the router packs)
    packed steps must all occur.  `samplings`: one SamplingParams per
    prompt (default greedy).  `runtime` overrides SERVE_RUNTIME; `setup`
    is called on the engine before anything is submitted; `mesh` and
    `rules` go to the engine.
    -> ({rid: tokens}, {rid: first-token logits}, metrics summary with the
    lane's width and segments)."""
    from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig

    model, params, all_prompts = served
    prompts = all_prompts if prompts is None else prompts
    cfg = model.cfg
    # an engine is freed only by a collection (the first-token spy makes a
    # cycle through it): collect the last runs' before this one allocates
    gc.collect()
    rcfg = RuntimeConfig(**{**SERVE_RUNTIME, **runtime}, cuda_graphs=graphs)
    eng = ContinuousEngine(model, params, rcfg, router=router, device=DEVICE,
                           mesh=mesh, rules=rules)
    firsts = _spy_first_logits(eng)
    if setup is not None:
        setup(eng)
    pools = ((eng.cache.conv, eng.cache.ssm) if eng.family == "ssm"
             else (eng.cache.k, eng.cache.v))
    log(f"[{label}] pools {' + '.join(str(tuple(p.shape)) for p in pools)} "
        f"{sum(p.numel() * p.element_size() for p in pools) / 1e9:.2f} GB")
    progs = (eng._unified, eng._decode_only)
    before = [p._cache_size() for p in progs]
    for i, p in enumerate(prompts):
        eng.submit(p, sampling=None if samplings is None else samplings[i])
    if before != [0, 0] or [p._cache_size() for p in progs] != [0, 0]:
        raise AssertionError(f"[{label}] submit() captured a program")
    torch.cuda.synchronize()
    if profile:
        from torch.profiler import ProfilerActivity
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            done = eng.run()
            torch.cuda.synchronize()
    else:
        done = eng.run()
        torch.cuda.synchronize()
    s = eng.metrics.summary()
    s["lane_width"], s["lane_segments"] = eng.adapter.chunk_width, eng.adapter.chunk_segments
    if profile:
        s["device_rows"] = _log_device_profile(prof, s["wall_s"], label)
    log(f"[{label}] {int(s['requests'])} requests, {int(s['tokens_out'])} "
        f"tokens in {s['wall_s']:.3f} s: {s['tokens_per_s']:.1f} tokens/s, "
        f"TTFT p50 {s['ttft_p50_s']:.3f} s p95 {s['ttft_p95_s']:.3f} s, "
        f"latency p95 {s['latency_p95_s']:.3f} s; steps: "
        f"{int(s['chunk_steps'])} unified ({int(s['prefill_chunks'])} chunks, "
        f"{int(s['packed_segments'])} packed segments, fill "
        f"{s['chunk_fill_frac']:.2f}), {int(s['decode_only_steps'])} "
        f"decode-only, {int(s['decode_steps'])} with decode rows; "
        f"prefill_time {s['prefill_time_s']:.3f} s decode_time "
        f"{s['decode_time_s']:.3f} s; preemptions {int(s['preemptions'])}, "
        f"prefix hit tokens {int(s['prefix_hit_tokens'])}")
    steps = int(s["chunk_steps"] + s["decode_only_steps"])
    sizes = [p._cache_size() for p in progs]
    captures = sum(p.captures for p in progs)
    replays = sum(p.replays for p in progs)
    log(f"[{label}] step programs: {sizes} signatures (unified, decode-only), "
        f"{captures} captures, {replays} replays over {steps} steps")
    want = (2, steps - 2) if graphs else (0, 0)
    if sizes != [1, 1] or (captures, replays) != want:
        raise AssertionError(f"[{label}] programs {sizes}, captures {captures}, "
                             f"replays {replays}: want [1, 1] and {want}")
    if len(done) != len(prompts):
        raise AssertionError(f"[{label}] {len(done)} of {len(prompts)} finished")
    for r in done:
        if len(r.output) != rcfg.max_new_tokens:
            raise AssertionError(f"[{label}] request {r.rid}: {len(r.output)} tokens")
        if not all(0 <= t < cfg.vocab for t in r.output):
            raise AssertionError(f"[{label}] request {r.rid}: token out of range")
    for rid, logits in firsts.items():
        if logits.shape != (cfg.vocab,) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"[{label}] request {rid}: bad first-token logits")
    eng.cache.alloc.check_invariants()
    if eng.cache.alloc.num_used != 0:
        raise AssertionError(f"[{label}] pool did not drain")
    if check_schedule and (s["decode_only_steps"] == 0
                           or s["prefill_chunks"] <= len(prompts)
                           or (require_packing and s["packed_segments"] == 0)):
        raise AssertionError(f"[{label}] chunking / packing / decode-only "
                             "steps did not all occur")
    return {r.rid: r.output for r in done}, firsts, s


def compare_first_tokens(torch, label, out_k, first_k, out_t, first_t, require=True):
    """First tokens of a run must match the torch lanes' wherever the
    torch lanes' top-2 margin exceeds FIRST_TOKEN_MARGIN; with `require`,
    at least one must have that margin.  -> the number compared."""
    compared, agree, max_dlogit = 0, 0, 0.0
    for rid, ref_logits in first_t.items():
        max_dlogit = max(max_dlogit,
                         (first_k[rid] - ref_logits).abs().max().item())
        top2 = torch.topk(ref_logits, 2).values
        margin = float(top2[0] - top2[1])
        if margin > FIRST_TOKEN_MARGIN:
            compared += 1
            agree += out_k[rid][0] == out_t[rid][0]
            if out_k[rid][0] != out_t[rid][0]:
                raise AssertionError(
                    f"request {rid}: first token {out_k[rid][0]} on the {label} "
                    f"vs {out_t[rid][0]} on the torch lanes at margin {margin:.3f}")
    same_stream = sum(out_k[r] == out_t[r] for r in out_t)
    log(f"[{label}] first tokens: {agree}/{compared} agree with the torch lanes "
        f"where their top-2 margin > {FIRST_TOKEN_MARGIN} (of {len(first_t)}); "
        f"max |logit difference| {max_dlogit:.4f}; whole 32-token streams "
        f"identical for {same_stream}/{len(out_t)}")
    if require and compared == 0:
        raise AssertionError("no request had a first-token margin to compare")
    return compared


def stream_check(torch, label, model, params, prompts, out):
    """Every token of greedy paged streams `out` against the dense torch
    path (`launch/steps.py::prefill_step` / `serve_step`: plain PyTorch
    ops, the same bf16 parameters), teacher-forced on the streams' own
    tokens: each prompt is prefilled alone (batch 1) into a cache of one
    common length, the caches are stacked and the streams' tokens go
    through `serve_step` together (a dense decoder's rows do not mix).
    Each token must be the dense path's argmax wherever its top-2 margin
    exceeds FIRST_TOKEN_MARGIN.  -> (tokens compared, tokens)."""
    from repro_torch.launch import steps

    n_new = SERVE_RUNTIME["max_new_tokens"]
    rids = sorted(out)
    max_seq = max(len(p) for p in prompts) + n_new
    compared = total = 0
    widest = 0.0
    t0 = time.perf_counter()
    with torch.no_grad():
        rows, caches = [], []
        for p in prompts:
            logits, cache = steps.prefill_step(
                model, params, torch.as_tensor(p[None], device=DEVICE), max_seq)
            rows.append(logits[:, -1])
            caches.append(cache)
        cache = {k: torch.cat([c[k] for c in caches], dim=0 if k == "lengths" else 1)
                 for k in caches[0]}
        del caches
        logits = torch.cat(rows)
        for j in range(n_new):
            top2 = torch.topk(logits.float(), 2)
            margins = (top2.values[:, 0] - top2.values[:, 1]).cpu().tolist()
            best = top2.indices[:, 0].cpu().tolist()
            for rid, margin, b in zip(rids, margins, best):
                total += 1
                widest = max(widest, margin)
                if margin > FIRST_TOKEN_MARGIN:
                    compared += 1
                    if b != out[rid][j]:
                        raise AssertionError(
                            f"[{label}] request {rid} token {j}: {out[rid][j]} on the "
                            f"kernel lanes vs {b} on the dense torch path at margin "
                            f"{margin:.3f}")
            if j + 1 < n_new:
                toks = torch.tensor([[out[rid][j]] for rid in rids], dtype=torch.int32,
                                    device=DEVICE)
                logits, cache = steps.serve_step(model, params, cache, toks)
                logits = logits[:, -1]
        del cache
    torch.cuda.synchronize()
    log(f"[{label}] every token against the dense torch path (teacher-forced, prefills "
        f"at batch 1, {len(rids)} streams decoded together, "
        f"{time.perf_counter() - t0:.1f} s): {compared}/{total} had a top-2 margin > "
        f"{FIRST_TOKEN_MARGIN}, all agree; the widest margin {widest:.3f}")
    return compared, total


# graphed / eager run order of the kernel lanes: two pairs, alternating
KERNEL_LANE_RUNS = (True, False, False, True)
# the identity pairs (graphed kernel lanes): the first 8 prompts; a pool of
# 120 blocks preempts them (they need 216 with their 32 new tokens); the
# first 12 with prompt 1's first 256 tokens as a shared prefix wherever
# they are longer, so the second wave adopts the first's blocks; an
# unchunked lane as wide as the longest prompt
IDENTITY_PROMPTS = 8
PREEMPT_BLOCKS = 120
SHARED_PROMPTS, SHARED_PREFIX = 12, 256
UNCHUNKED_TOKENS = 704


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _lane_stats(label, summaries):
    """Log one lane's runs: tokens/s and TTFT p50 / p95 of each, their
    medians and spread (max - min).  -> median tokens/s."""
    tps = [s["tokens_per_s"] for s in summaries]
    p50 = [s["ttft_p50_s"] for s in summaries]
    p95 = [s["ttft_p95_s"] for s in summaries]
    med = _median(tps)
    log(f"[{label}] {len(tps)} runs: tokens/s {[round(x, 1) for x in tps]} median "
        f"{med:.1f} spread {max(tps) - min(tps):.1f} ({100 * (max(tps) - min(tps)) / med:.1f}%); "
        f"TTFT p50 {[round(x, 3) for x in p50]} s median {_median(p50):.3f} spread "
        f"{max(p50) - min(p50):.3f}; TTFT p95 {[round(x, 3) for x in p95]} s median "
        f"{_median(p95):.3f} spread {max(p95) - min(p95):.3f}")
    return med


def _first_divergence(out_a, out_b):
    """(rid, token index, token a, token b) of the first stream that
    differs, or None."""
    for rid in sorted(out_a):
        for i, (a, b) in enumerate(zip(out_a[rid], out_b[rid])):
            if a != b:
                return rid, i, a, b
    return None


def _geometry_diff(cfg, s_a, s_b):
    """The launch geometry that differs between two runs' prefill lanes:
    each serving GEMM's M (the lane width; the segment count for lm_head)
    and `gemm_geometry`, and the torch-lane wo product's M (cuBLAS picks
    its own algorithm from the shape)."""
    import torch
    from repro_torch.kernels.matmul import gemm_geometry

    diffs = []
    for role, k, n, _ in serving_gemms(cfg):
        key = "lane_segments" if role == "lm_head" else "lane_width"
        m_a, m_b = int(s_a[key]), int(s_b[key])
        g_a, g_b = (gemm_geometry(m, n, k, torch.bfloat16) for m in (m_a, m_b))
        if (m_a, g_a) != (m_b, g_b):
            diffs.append(f"{role} M {m_a} -> {m_b}, (bm, bn, bk, stages, split) "
                         f"{tuple(g_a)} -> {tuple(g_b)}")
    if s_a["lane_width"] != s_b["lane_width"]:
        diffs.append(f"attn wo (cuBLAS) M {int(s_a['lane_width'])} -> "
                     f"{int(s_b['lane_width'])}; paged prefill grid over "
                     f"{int(s_a['lane_width'])} -> {int(s_b['lane_width'])} rows")
    return diffs or ["none"]


def _same_firsts(first_a, first_b):
    torch = sys.modules["torch"]
    return first_a.keys() == first_b.keys() and all(
        torch.equal(first_a[r], first_b[r]) for r in first_a)


def phase_identities(torch, served, router):
    """The reference's schedule identities on the graphed kernel lanes:
    preempted = unconstrained and sharing-on = sharing-off bitwise (the
    same shapes run); chunked vs unchunked and packed vs single-segment
    (other GEMM shapes) held to the first tokens wherever the top-2 margin
    exceeds FIRST_TOKEN_MARGIN, whole-stream identity logged with the first
    diverging token and the geometry that differs."""
    model, _, prompts = served
    cfg = model.cfg
    few = prompts[:IDENTITY_PROMPTS]
    shared = [p.copy() for p in prompts[:SHARED_PROMPTS]]
    for p in shared:
        if len(p) > SHARED_PREFIX:
            p[:SHARED_PREFIX] = prompts[1][:SHARED_PREFIX]
    pairs = [("preempted vs unconstrained", few, dict(num_blocks=PREEMPT_BLOCKS), {}, True),
             ("sharing-on vs sharing-off", shared, dict(prefix_sharing=True), {}, True),
             ("chunked 256 vs unchunked", few, {}, dict(chunk_tokens=UNCHUNKED_TOKENS), False),
             ("packed 4 vs single-segment", few, {}, dict(chunk_segments=1), False)]
    for name, ps, rt_a, rt_b, bitwise in pairs:
        a_label, b_label = name.split(" vs ")
        out_a, first_a, s_a = serve(torch, served, router, f"identity: {a_label}",
                                    prompts=ps, check_schedule=False, **rt_a)
        out_b, first_b, s_b = serve(torch, served, router, f"identity: {b_label}",
                                    prompts=ps, check_schedule=False, **rt_b)
        if "preempted" in name and not s_a["preemptions"] > 0:
            raise AssertionError("the small pool preempted nothing")
        if "sharing" in name and not s_a["prefix_hit_tokens"] > 0:
            raise AssertionError("no prefix was adopted")
        same = sum(out_a[r] == out_b[r] for r in out_a)
        div = _first_divergence(out_a, out_b)
        firsts = _same_firsts(first_a, first_b)
        geo = _geometry_diff(cfg, s_a, s_b)
        log(f"[identity] {name}: whole 32-token streams identical for {same}/"
            f"{len(out_a)}; first-token logits bitwise equal: {firsts}; first "
            f"diverging token: {'none' if div is None else 'request %d token %d: %d vs %d' % div}; "
            f"geometry that differs: {'; '.join(geo)}")
        if bitwise:
            if div is not None or not firsts:
                raise AssertionError(f"{name}: not bitwise equal ({div})")
            continue
        compared = 0
        for rid, logits in first_a.items():
            top2 = torch.topk(logits, 2).values
            margin = float(top2[0] - top2[1])
            if margin > FIRST_TOKEN_MARGIN:
                compared += 1
                if out_a[rid][0] != out_b[rid][0]:
                    raise AssertionError(
                        f"{name}: request {rid} first token {out_a[rid][0]} vs "
                        f"{out_b[rid][0]} at margin {margin:.3f}")
        log(f"[identity] {name}: first tokens agree for {compared}/{len(first_a)} "
            f"requests with a top-2 margin > {FIRST_TOKEN_MARGIN}")
        if compared == 0:
            raise AssertionError(f"{name}: no first-token margin to compare")


def kernel_lane_router(block_q):
    """The hand-built all-kernel plan: both decoder lanes' attention on the
    paged kernels (`block_q`, 4 segments a chunk) and every role-tagged
    matmul on the GEMM at its default geometry."""
    from repro_torch.core.plan import InferencePlan, OpChoice
    from repro_torch.kernels.dispatch import MATMUL_ROLES
    from repro_torch.serve.router import PlanRouter

    plan = InferencePlan("serve", "h100")
    for stage in ("decode", "prefill_chunk"):
        plan.choices[f"{stage}.attention"] = OpChoice(
            "cuda_attention", {"block_q": block_q, "max_segments": 4}, 0.0)
        for role in MATMUL_ROLES:
            plan.choices[f"{stage}.{role}"] = OpChoice("cuda_matmul", {}, 0.0)
    return PlanRouter(plan)


def _serve_counters():
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import matmul as KM
    from repro_torch.kernels import sampling as KS

    return (KA.paged_decode_attention, KA.paged_prefill_attention,
            KM.matmul_fused, KS.sample_draw)


def _kernel_lane_pairs(torch, served, router, label, order, profile, counters,
                       **serve_kw):
    """Serve on the kernel lanes graphed and eager in `order` (`serve_kw`
    go to `serve`): streams, first-token logits and launches bitwise equal
    across the runs, every counter launched (a replay counting what it
    captured).  -> (the first run's streams, first-token logits, summary
    and launches, the first graphed engine, median tokens/s per lane).
    Only that engine is kept: the others, their pools and captured graphs
    are freed as their runs end."""
    runs, engines = [], []

    def keep_first(eng):
        if not engines:
            engines.append(eng)

    for graphs in order:
        for fn in counters:
            fn.launches = 0
        lane = "graphed" if graphs else "eager"
        out, first, s = serve(torch, served, router, f"{label} kernel lanes, {lane}",
                              profile, graphs=graphs, setup=keep_first,
                              **serve_kw)
        runs.append((graphs, out, first, s, {fn.__name__: fn.launches
                                              for fn in counters}))
    _, out_k, first_k, s_k, launches = runs[0]
    for graphs, out, first, _, n in runs[1:]:
        if out != out_k or not _same_firsts(first, first_k) or n != launches:
            raise AssertionError(
                f"{label} kernel lanes ({'graphed' if graphs else 'eager'}) differ "
                f"from the first graphed run: streams {out == out_k}, launches {n} "
                f"vs {launches}, first divergence {_first_divergence(out_k, out)}")
    log(f"[{label}] kernel lanes: {len(runs)} runs, graphed and eager, give the same "
        f"token streams, first-token logits (bitwise) and launches {launches}")
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched on the serving path")
    med = {}
    if not profile:
        med = {g: _lane_stats(f"{label} kernel lanes, {'graphed' if g else 'eager'}",
                              [r[3] for r in runs if r[0] == g]) for g in (True, False)}
        log(f"[{label}] kernel lanes: graphed / eager median tokens/s "
            f"{med[True] / med[False]:.2f}x")
    return out_k, first_k, s_k, launches, engines[0], med


def phase_serve(torch, served, block_q, profile=False):
    from repro_torch.serve.router import PlanRouter

    router = kernel_lane_router(block_q)
    # the kernel lanes graphed and eager in alternating pairs: the same
    # streams, first-token logits and kernel launches, bit for bit
    out_k, first_k, _, launches, _, med = _kernel_lane_pairs(
        torch, served, router, "qwen3", KERNEL_LANE_RUNS, profile, _serve_counters())

    torch_run = serve(torch, served, PlanRouter(None), "torch lanes, graphed", profile)
    if profile:
        serve(torch, served, PlanRouter(None), "torch lanes, eager", profile,
              graphs=False)
    compare_first_tokens(torch, "kernel lanes", out_k, first_k, *torch_run[:2])
    phase_identities(torch, served, router)
    return launches, torch_run, router, out_k, med.get(True)


# ------------------------------------------------------------ phase 6
# Sampled serving: phase 3's 16 prompts on the graphed kernel lanes with the
# bench's mixed cycle (benchmarks/bench_serving.py:158-169: greedy / T 0.8 /
# T 1.0 top-k 8 / T 0.9 top-p 0.85, seed 1000 + i), every token drawn by the
# draw kernel inside the captured step programs.
def _mix(i):
    from repro_torch.serve.sampling import SamplingParams

    r = i % 4
    if r == 0:
        return SamplingParams()
    if r == 1:
        return SamplingParams(temperature=0.8, seed=1000 + i)
    if r == 2:
        return SamplingParams(temperature=1.0, top_k=8, seed=1000 + i)
    return SamplingParams(temperature=0.9, top_p=0.85, seed=1000 + i)


def _draw_margin(torch, logits, sampling, rid):
    """The top-2 margin of what a first token is the argmax of: the
    logits of a greedy request; else the masked, temperature-scaled
    logits plus the Gumbel noise of its key (seed, rid, 0)."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import sampling as KS

    x = logits.to(DEVICE).float()[None]
    if not sampling.greedy:
        x = x / max(sampling.temperature, KS.TEMP_EPS)
        x = KS.mask_top_k(x, torch.tensor([sampling.top_k], device=DEVICE))
        x = KS.mask_top_p(x, torch.tensor([sampling.top_p], device=DEVICE))
        keys = torch.tensor([[sampling.seed, rid, 0]], dtype=torch.int32, device=DEVICE)
        u = R.uniform_from_bits(R.random_bits(R.derive_key(keys), x.shape[-1]))
        x = R.gumbel_from_uniform(u) + x
    top2 = torch.topk(x[0], 2).values
    return float(top2[0] - top2[1])


def _h2d_bytes(prof, copies):
    """Bytes of the host-to-device copies in a profiler trace that holds a
    commit of `copies` host-to-device copies, read from the device's memcpy
    records.  -> (bytes, None), or (None, why) when the trace is incomplete:
    fewer memcpy calls than the commit issues, or a call whose device
    record (same correlation id) is missing or carries no byte count.  The
    profiler can drop records from a long process's trace; a partial sum
    is not a measurement."""
    path = os.path.join(ROOT, "build", f"commit_trace_{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    calls = [e.get("args", {}).get("correlation") for e in events
             if e.get("ph") == "X" and str(e.get("name", "")).startswith("cudaMemcpy")]
    records = {e.get("args", {}).get("correlation"): e for e in events
               if e.get("ph") == "X" and str(e.get("name", "")).startswith("Memcpy ")}
    unmatched = [c for c in calls
                 if records.get(c, {}).get("args", {}).get("bytes") is None]
    if len(calls) < copies or unmatched:
        return None, (f"{len(calls)} memcpy calls for the commit's {copies} copies, "
                      f"{len(unmatched)} without a device record with bytes")
    return sum(records[c]["args"]["bytes"] for c in calls
               if "HtoD" in str(records[c].get("name"))), None


def _bytes_note(measured, why):
    return (f"{measured} bytes measured (profiler memcpy records)" if why is None
            else f"not measured: the profiler trace is incomplete ({why})")


def phase_sampled(torch, served, router, greedy_out, profile=False):
    """Sampled serving on the graphed kernel lanes (see the module
    docstring, phase 6).  -> the draw kernel's and the serving kernels'
    launches on the sampled path."""
    from torch.profiler import ProfilerActivity

    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import matmul as KM
    from repro_torch.kernels import sampling as KS
    from repro_torch.serve.engine import FixedBatchEngine, ServeConfig

    import numpy as np

    t_phase = time.perf_counter()
    model, params, prompts = served
    mix = [_mix(i) for i in range(len(prompts))]
    counters = (KA.paged_decode_attention, KA.paged_prefill_attention,
                KM.matmul_fused, KS.sample_draw)
    for fn in counters:
        fn.launches = 0
    engines = []
    out_s, first_s, s_s = serve(torch, served, router, "sampled, graphed", profile,
                                samplings=mix, setup=engines.append)
    launches = {fn.__name__: fn.launches for fn in counters}
    eng = engines[0]
    want_draws = 2 * int(s_s["chunk_steps"]) + int(s_s["decode_only_steps"])
    log(f"[sampled] launches on the sampled path: {launches}; the draw kernel "
        f"{launches['sample_draw']} = 2 x {int(s_s['chunk_steps'])} unified + "
        f"{int(s_s['decode_only_steps'])} decode-only steps")
    if launches["sample_draw"] != want_draws or min(launches.values()) <= 0:
        raise AssertionError(f"sampled path launches {launches}: want "
                             f"{want_draws} draws and every kernel")
    sizes = (eng._unified._cache_size(), eng._decode_only._cache_size())
    if sizes != (1, 1):
        raise AssertionError(f"sampled serving: step programs {sizes}, want (1, 1)")
    if profile:
        rows = s_s["device_rows"]
        busy = sum(t for t, _, _ in rows)
        draw = sum(t for t, key, _ in rows if "draw_kernel" in key)
        steps = int(s_s["chunk_steps"] + s_s["decode_only_steps"])
        log(f"[sampled] the draw kernel's device share of the graphed steps: "
            f"{draw / 1e3:.3f} ms of {busy / 1e3:.3f} ms device time "
            f"({100 * draw / max(busy, 1e-9):.2f} %), {draw / steps:.2f} of "
            f"{busy / steps:.1f} device us a step over {steps} steps")
    else:
        log("[sampled] the draw kernel's device share: not measured here "
            "(python3 chip_smoke.py --profile logs it)")

    out_e, first_e, _ = serve(torch, served, router, "sampled, eager", graphs=False,
                              samplings=mix)
    if out_e != out_s or not _same_firsts(first_e, first_s):
        raise AssertionError(f"sampled: graphed != eager, first divergence "
                             f"{_first_divergence(out_s, out_e)}")
    greedy_rids = [i + 1 for i, m in enumerate(mix) if m.greedy]
    if any(out_s[r] != greedy_out[r] for r in greedy_rids):
        raise AssertionError("sampled: a greedy request's stream differs from "
                             "phase 3's greedy run")
    n_diff = sum(out_s[r] != greedy_out[r] for r in out_s if r not in greedy_rids)
    log(f"[sampled] graphed = eager bitwise (streams, first-token logits); the "
        f"{len(greedy_rids)} greedy requests equal phase 3's greedy streams; "
        f"{n_diff} of {len(out_s) - len(greedy_rids)} sampled streams differ "
        "from greedy")
    if n_diff == 0:
        raise AssertionError("sampled: no sampled stream differs from greedy")

    # preempted = unconstrained, with the commit's bytes and time
    few = prompts[:IDENTITY_PROMPTS]
    commits, held = [], []

    def watch_commits(e):
        ad = e.adapter
        orig = ad.resume_commit

        def resume_commit(group):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
                nbytes = orig(group)
                torch.cuda.synchronize()
            commits.append((sum(nbytes), ad.last_commit_h2d_bytes,
                            _h2d_bytes(prof, 2 * len(group) + 1), len(group)))
            return nbytes

        ad.resume_commit = resume_commit
        held.append(e)

    out_p, first_p, s_p = serve(torch, served, router, "sampled, preempted",
                                prompts=few, samplings=mix, check_schedule=False,
                                num_blocks=PREEMPT_BLOCKS, setup=watch_commits)
    out_u, first_u, _ = serve(torch, served, router, "sampled, unconstrained",
                              prompts=few, samplings=mix, check_schedule=False)
    pe = held[0]
    sizes = (pe._unified._cache_size(), pe._decode_only._cache_size(),
             pe._commit._cache_size(), pe._cow._cache_size())
    log(f"[sampled] preempted: {int(s_p['preemptions'])} preemptions, "
        f"{int(s_p['resume_commits'])} resume commits; programs (unified, "
        f"decode-only, commit, cow) {sizes}")
    if not (s_p["preemptions"] >= 1 and s_p["resume_commits"] >= 1):
        raise AssertionError("sampled: the 120-block pool preempted nothing")
    if sizes[:3] != (1, 1, 1):
        raise AssertionError(f"sampled, preempted: program signatures {sizes}")
    if out_p != out_u or not _same_firsts(first_p, first_u):
        raise AssertionError(f"sampled: preempted != unconstrained, first "
                             f"divergence {_first_divergence(out_u, out_p)}")
    kv = pe.adapter._commit_kv
    padded = 2 * kv[0].numel() * kv[0].element_size()
    for swapped, counted, (measured, why), n in commits:
        ids = counted - swapped
        log(f"[sampled] commit of {n} request(s): swapped {swapped} bytes; "
            f"host-to-device {counted} bytes counted (swapped + {ids} of block "
            f"ids), {_bytes_note(measured, why)}; the padded inputs {padded} bytes")
        if ids != pe.kv_cfg.max_blocks_per_seq * pe.adapter.resume_segments * 4:
            raise AssertionError(f"commit: {counted} bytes != swapped + ids")
        if measured is not None and measured != counted:
            raise AssertionError(f"commit: {measured} bytes crossed the bus, "
                                 f"{counted} counted")
    bound = (pe.cache.k, pe.cache.v, *kv)
    ids = np.full((pe.adapter.resume_segments, pe.kv_cfg.max_blocks_per_seq), 0, np.int32)
    ms = time_ms(torch, [lambda: pe._commit(bound, (ids,))], iters=20)
    log(f"[sampled] commit program ms (replays, CUDA events, host staging of "
        f"the ids included): {ms:.4f}; {pe._commit.replays} replays in all")

    # sharing-on = sharing-off
    shared = [p.copy() for p in prompts[:SHARED_PROMPTS]]
    for p in shared:
        if len(p) > SHARED_PREFIX:
            p[:SHARED_PREFIX] = prompts[1][:SHARED_PREFIX]
    held.clear()
    out_on, first_on, s_on = serve(torch, served, router, "sampled, sharing on",
                                   prompts=shared, samplings=mix, check_schedule=False,
                                   prefix_sharing=True, setup=held.append)
    out_off, first_off, _ = serve(torch, served, router, "sampled, sharing off",
                                  prompts=shared, samplings=mix, check_schedule=False)
    se = held[0]
    sizes = (se._unified._cache_size(), se._decode_only._cache_size(),
             se._commit._cache_size(), se._cow._cache_size())
    log(f"[sampled] sharing on: {int(s_on['prefix_hit_tokens'])} prefix-hit tokens, "
        f"{int(s_on['cow_copies'])} CoW copies; programs (unified, decode-only, "
        f"commit, cow) {sizes}")
    if not s_on["prefix_hit_tokens"] > 0 or sizes[:2] != (1, 1) or sizes[3] > 1:
        raise AssertionError(f"sampled, sharing on: hits "
                             f"{s_on['prefix_hit_tokens']}, programs {sizes}")
    if out_on != out_off or not _same_firsts(first_on, first_off):
        raise AssertionError(f"sampled: sharing on != off, first divergence "
                             f"{_first_divergence(out_off, out_on)}")
    log("[sampled] preempted = unconstrained and sharing-on = sharing-off, "
        "bitwise (streams, first-token logits)")

    # the fixed-batch engine at batch 1, unpadded, on one prompt of each mix
    n_fixed = 4
    fixed = FixedBatchEngine(model, params,
                             ServeConfig(batch_size=1, max_seq=SERVE_PLAN["max_seq"],
                                         max_new_tokens=SERVE_RUNTIME["max_new_tokens"]),
                             device=DEVICE)
    for i in range(n_fixed):
        fixed.submit(prompts[i], sampling=mix[i])
    t0 = time.perf_counter()
    out_f = {r.rid: r.output for r in fixed.run()}
    torch.cuda.synchronize()
    compared = 0
    for rid in sorted(out_f):
        margin = _draw_margin(torch, first_s[rid], mix[rid - 1], rid)
        same = out_f[rid] == out_s[rid]
        div = _first_divergence({rid: out_s[rid]}, {rid: out_f[rid]})
        log(f"[sampled] fixed batch request {rid} ({'greedy' if mix[rid - 1].greedy else mix[rid - 1]}): "
            f"first token {out_f[rid][0]} vs {out_s[rid][0]} continuous, draw "
            f"margin {margin:.3f}; whole stream identical {same}; first diverging "
            f"token {'none' if div is None else 'index %d: %d vs %d' % div[1:]}")
        if margin > FIRST_TOKEN_MARGIN:
            compared += 1
            if out_f[rid][0] != out_s[rid][0]:
                raise AssertionError(f"fixed batch request {rid}: first token "
                                     f"differs at margin {margin:.3f}")
    log(f"[sampled] fixed batch: {n_fixed} requests in "
        f"{time.perf_counter() - t0:.1f} s; first tokens agree for {compared}/"
        f"{n_fixed} with a draw margin > {FIRST_TOKEN_MARGIN}")
    if compared == 0:
        raise AssertionError("fixed batch: no first-token margin to compare")
    log(f"[sampled] phase seconds: {time.perf_counter() - t_phase:.1f}")
    return launches


# ------------------------------------------------------------ phase 5
# The slice's path: the paper's system-level exploration applied to the
# serve graph.  build_serve_graph -> build_serve_plan (select on
# wall-clock fitness on the card: the vendor lane against the flash kernel
# for each attention node, against the GEMM for each matmul) ->
# PlanRouter(plan) -> ContinuousEngine, at the serving phase's widths.
SERVE_PLAN = dict(prefill_len=max(PROMPT_LENS), slots=SERVE_RUNTIME["max_slots"],
                  max_seq=SERVE_RUNTIME["block_size"] * SERVE_RUNTIME["max_blocks_per_seq"],
                  chunk_tokens=SERVE_RUNTIME["chunk_tokens"])


def _log_race(graph, plan, tuner):
    """How many matmul nodes the GEMM won, and the race per node."""
    from repro_torch.core import TEMPLATES, op_desc_of, roofline_bound

    matmuls = [n.name for n in graph.toposort()
               if getattr(op_desc_of(graph, n, "bfloat16"), "kind", None) == "matmul"]
    won = [n for n in matmuls if plan.choices[n].backend == "pallas_matmul"]
    log(f"the GEMM kernel won {len(won)} of the {len(matmuls)} matmul nodes against "
        f"the vendor lane (one bf16 cuBLAS product): {won}")
    log(f"per node: vendor ms, kernel ms (config), winner, bound ms (bf16 peak); "
        f"{tuner.fitness.kind} fitness"
        + (" (device time: calls replayed in a CUDA graph, median of 10 replays)"
           if tuner.fitness.kind == "wallclock" else ""))
    for node in graph.toposort():
        op = op_desc_of(graph, node, "bfloat16")
        c = plan.choices[node.name]
        kname = "pallas_attention" if op.kind == "attention" else "pallas_matmul"
        tuned = tuner.tune(op, TEMPLATES[kname]).config     # a cache hit
        d = op.d
        shape = (f"B={d['b']} Sq={d['q']} Skv={d['kv']} H={d['h']} D={d['d']}"
                 if op.kind == "attention" else f"{d['m']}x{d['k']}->{d['n']}")
        note = ""
        if op.kind == "attention" and d["q"] < d["kv"]:
            note = (f"  [unequal work: the kernel's top-left mask passes "
                    f"{_causal_pairs(d['q'], d['kv'])} (query, key) pairs a "
                    f"head, the vendor's bottom-right mask "
                    f"{sum(d['kv'] - d['q'] + i + 1 for i in range(d['q']))}]")
        log(f"  {node.name:24s} {shape:30s} vendor {1e3 * c.candidates['xla']:.4f} "
            f"kernel {1e3 * c.candidates[kname]:.4f} ({tuned}) winner {c.backend} "
            f"bound {1e3 * roofline_bound(op):.4f}{note}")


def _log_search(tuner, label):
    """Each searched operator's genetic and RL results (best us, evals,
    wall s) and the winner (the faster; a tie where both found the same
    time, cached under the first method), then the wins and the summed
    evals and wall seconds per method."""
    by_op = {}
    for r in tuner.log:
        by_op.setdefault((r.op.signature(), r.template), []).append(r)
    wins, evals, secs = {}, {}, {}
    log(f"[{label}] search per operator: method best us (evals, wall s); winner")
    for (_, template), results in by_op.items():
        best = min(results, key=lambda r: r.runtime_s)
        tied = sum(r.runtime_s == best.runtime_s for r in results) > 1
        winner = "tie" if tied else best.method
        wins[winner] = wins.get(winner, 0) + 1
        for r in results:
            evals[r.method] = evals.get(r.method, 0) + r.evals
            secs[r.method] = secs.get(r.method, 0.0) + r.wall_s
        log(f"  {results[0].op.label:28s} {template:16s} " + "; ".join(
            f"{r.method} {1e6 * r.runtime_s:.2f} ({r.evals}, {r.wall_s:.2f} s) {r.config}"
            for r in results) + f"; winner {winner}")
    log(f"[{label}] search over {len(by_op)} operators: wins {wins}; evals {evals}; "
        f"wall s {({k: round(v, 2) for k, v in secs.items()})}")
    if set(evals) != {"genetic", "rl"}:
        raise AssertionError(f"[{label}] searches run: {sorted(evals)}")


def race_and_serve(torch, served, counters, label, torch_run, kernel_tps=None,
                   tuner=None):
    """A decoder's serve plan tuned by `build_serve_plan` (GA and RL-search)
    on device-time fitness on the card — the flash kernel and the GEMM must
    launch in the race, which is logged per node — or on `tuner` (the
    analytic model: nothing launches); then the prompts served under
    `PlanRouter(plan)`, graphed: exactly the plan's kernel lanes launch and
    first tokens match `torch_run`'s (the torch lanes) at the margin.
    -> (launches in the race, launches serving, the plan, its tokens/s)."""
    from repro_torch.core import Tuner, WallClockFitness
    from repro_torch.serve.router import PlanRouter, build_serve_graph, build_serve_plan

    cfg = served[0].cfg
    measured = tuner is None
    tuner = tuner or Tuner(fitness=WallClockFitness(device=DEVICE))  # GA and RL
    fitness = tuner.fitness
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    plan = build_serve_plan(cfg, **SERVE_PLAN, tuner=tuner, dtype="bfloat16")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    race = {fn.__name__: fn.launches for fn in counters if fn.launches}
    log(f"build_serve_plan {cfg.name} {SERVE_PLAN} bf16 on {fitness.kind} fitness: "
        f"{wall:.2f} s wall; fitness calls {fitness.evals}, distinct measurements "
        f"{getattr(fitness, 'measured', 0)}; backends {plan.backend_histogram()}; "
        f"launches in the race {race}")
    for name in ("flash_attention", "matmul_fused"):
        if measured != bool(race.get(name)):
            raise AssertionError(f"{name}: {race.get(name, 0)} launches in the "
                                 f"{fitness.kind} race")

    graph = build_serve_graph(cfg, **SERVE_PLAN, dtype="bfloat16")
    _log_search(tuner, f"{label} serve plan")
    _log_race(graph, plan, tuner)

    router = PlanRouter(plan)
    log(f"[{label}] PlanRouter(plan).describe(): {router.describe()}")
    log(f"[{label}] lanes: decode attention {router.attention_backend('decode')}, "
        f"chunk attention {router.attention_backend('prefill_chunk')}, chunk_segments "
        f"{router.chunk_segments(default=SERVE_RUNTIME['chunk_segments'])}, "
        f"decode matmuls {router.matmul_table('decode')}, chunk matmuls "
        f"{router.matmul_table('prefill_chunk')}")
    for fn in counters:
        fn.launches = 0
    packs = min(SERVE_RUNTIME["chunk_segments"],
                router.chunk_segments(default=SERVE_RUNTIME["chunk_segments"])) > 1
    out, first, s_plan = serve(torch, served, router, f"{label} tuned plan",
                               require_packing=packs)
    serving = {fn.__name__: fn.launches for fn in counters if fn.launches}
    log(f"[{label}] launches serving under the tuned plan: {serving}")
    log(f"[{label}] tokens/s, graphed, this call: tuned plan "
        f"{s_plan['tokens_per_s']:.1f}, kernel lanes "
        f"{'n/a' if kernel_tps is None else f'{kernel_tps:.1f}'} (median), torch "
        f"lanes {torch_run[2]['tokens_per_s']:.1f}")
    want = {"sample_draw"}          # every step draws, greedy rows too
    for stage, kernel in (("decode", "paged_decode_attention"),
                          ("prefill_chunk", "paged_prefill_attention")):
        if router.attention_backend(stage)[0] == "cuda_attention":
            want.add(kernel)
        if any(b == "cuda_matmul" for b, _ in router.matmul_table(stage).values()):
            want.add("matmul_fused")
    if set(serving) != want:
        raise AssertionError(f"launches {serving}: the plan's kernel lanes are {want}")
    compare_first_tokens(torch, f"{label} tuned plan", out, first, *torch_run[:2])
    return race, serving, plan, s_plan["tokens_per_s"]


def phase_serve_plan(torch, served, counters, torch_run, kernel_tps=None):
    from repro_torch.core import ref_ops
    from repro_torch.kernels import ops as kops

    cfg = served[0].cfg
    # the race's vendor lane of a bf16 matmul is the lane serving runs: one
    # bf16 cuBLAS product (f32 accumulation, one rounding); held against
    # the f32 upcast it replaced, at the 10 serving GEMM shapes
    g = torch.Generator(device=DEVICE).manual_seed(10)
    for m in (8, 256):
        for role, k, n, _ in serving_gemms(cfg):
            x = torch.randn((m, k), generator=g, device=DEVICE).to(torch.bfloat16)
            w = (torch.randn((k, n), generator=g, device=DEVICE) / math.sqrt(k)
                 ).to(torch.bfloat16)
            lane = ref_ops.run_op("fused_matmul", [x, w], {})
            upcast = torch.matmul(x.float(), w.float()).to(torch.bfloat16)
            err = (lane.float() - upcast.float()).abs().max().item()
            tol = MM_RTOL_BF16 * max(1.0, upcast.float().abs().max().item())
            log(f"  vendor matmul lane {role} M={m} K={k} N={n}: one bf16 product vs "
                f"the f32 upcast max_abs_err {err:.3e} tol {tol:.1e} "
                f"{'ok' if err <= tol else 'FAIL'}")
            if not err <= tol:
                raise AssertionError(f"vendor matmul lane {role} M={m}: {err} > {tol}")
    race, serving, plan, plan_tps = race_and_serve(torch, served, counters, "qwen3",
                                                   torch_run, kernel_tps)

    # the second ported wrapper of the slice, through its public entry point
    # at the decode stage's shape (no JAX path calls flash_decode_padded)
    g = torch.Generator(device=DEVICE).manual_seed(9)
    b, s = SERVE_PLAN["slots"], SERVE_PLAN["max_seq"]
    q = torch.randn((b, cfg.n_heads, cfg.hd), generator=g, device=DEVICE).bfloat16()
    kc, vc = (torch.randn((b, s, cfg.n_kv_heads, cfg.hd), generator=g,
                          device=DEVICE).bfloat16() for _ in range(2))
    lengths = torch.tensor([n + 32 for n in PROMPT_LENS[:b]], dtype=torch.int32,
                           device=DEVICE)
    for fn in counters:
        fn.launches = 0
    out = kops.attention_decode(q, kc, vc, lengths)
    torch.cuda.synchronize()
    decode = {fn.__name__: fn.launches for fn in counters if fn.launches}
    if decode != {"dense_decode_attention": 1} or out.shape != q.shape or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"ops.attention_decode: launches {decode}, "
                             f"shape {tuple(out.shape)}")
    log(f"ops.attention_decode at B={b} S={s} H={cfg.n_heads} Hkv={cfg.n_kv_heads} "
        f"D={cfg.hd} lengths {lengths.tolist()}: finite {tuple(out.shape)}; "
        f"launches {decode}")
    return {"serve_plan_race": race, "serve_plan_serve": serving,
            "ops_attention_decode": decode}, plan, plan_tps


# ------------------------------------------------------------ phase 7
# mamba2-2.7b at full width (d_model 2560, 80 heads x 64, state 128, conv
# 4, vocab 50,280, bf16, random weights from seed 0) and SSM_SERVE_LAYERS
# of its 64 layers (an earlier path, cut for the script's time limit: its
# eager runs and the fixed-batch loop grow with depth, the gates do not)
# served through ContinuousEngine on the slot-pooled state cache: the 16
# prompts of phase 3 over this vocabulary, SERVE_RUNTIME's 8 slots, 256-token
# chunks (one ssm_chunk) and 32 new tokens.
SSM_SERVE_LAYERS = 16
SSM_KERNEL_RUNS = (True, False)                   # one pair
SSM_PREEMPT_ROWS = 8          # state_slots: 7 usable rows for 8 slots
SSM_FIXED_PROMPTS = 4
SSM_DECODE_REPLAYS = 20


def ssm_setup(torch, cfg):
    """mamba2-2.7b initialised on the card (seed 0, one f32 layer at a time
    by `init_serving`) and the 16 prompts."""
    import numpy as np

    from repro_torch.models import MambaLM

    model = MambaLM(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = model.init_serving(gen)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    log(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} heads x "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv {cfg.conv_width}, vocab "
        f"{cfg.vocab}; {sum(t.numel() for t in leaves) / 1e9:.3f} G params "
        f"({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB) "
        f"initialised on the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    return model, params, prompts


def ssm_decode_bound(cfg, slots):
    """(ms, bytes) of a decode-only step's bytes bound: the in_proj and
    out_proj weights of every layer and lm_head (bf16) read once, each
    slot's SSM and conv state (f32) read and written once."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nh = d_in // cfg.ssm_head_dim
    proj = 2 * d_in + 2 * cfg.ssm_state + nh
    conv_dim = d_in + 2 * cfg.ssm_state
    weights = 2 * cfg.n_layers * (d * proj + d_in * d) + 2 * d * cfg.vocab
    state = 2 * 4 * slots * cfg.n_layers * (nh * cfg.ssm_head_dim * cfg.ssm_state
                                            + (cfg.conv_width - 1) * conv_dim)
    return 1e3 * (weights + state) / HBM_BPS, weights + state


def _replay_ms(torch, prog, replays=SSM_DECODE_REPLAYS):
    """Device ms of one replay of `prog`'s captured graph (CUDA events
    around back-to-back replays)."""
    graph = next(iter(prog._signatures.values())).graph
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def ssm_kernel_router():
    """The ssm family's all-kernel plan: in_proj, out_proj and lm_head of
    both ssm stages on the GEMM at its default geometry."""
    from repro_torch.core.plan import InferencePlan, OpChoice
    from repro_torch.serve.router import SSM_MATMUL_ROLES, PlanRouter

    plan = InferencePlan("serve_ssm", "h100")
    for stage in ("ssm_prefill_chunk", "ssm_decode"):
        for role in SSM_MATMUL_ROLES:
            plan.choices[f"{stage}.{role}"] = OpChoice("cuda_matmul", {}, 0.0)
    return PlanRouter(plan)


def phase_ssm(torch, cfg, profile=False):
    """mamba2-2.7b served on the card (see the module docstring, phase 7).
    -> the kernels' launches on each of its paths."""
    import numpy as np
    from torch.profiler import ProfilerActivity

    from repro_torch.core import Tuner, WallClockFitness
    from repro_torch.kernels import matmul as KM
    from repro_torch.kernels import sampling as KS
    from repro_torch.serve.engine import FixedBatchEngine, ServeConfig
    from repro_torch.serve.router import PlanRouter, build_serve_graph, build_serve_plan

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    served = ssm_setup(torch, cfg)
    prompts = served[2]
    counters = (KM.matmul_fused, KS.sample_draw)

    def zero():
        for fn in counters:
            fn.launches = 0

    def counts():
        return {fn.__name__: fn.launches for fn in counters}

    # 1. kernel lanes (every projection of both ssm stages on the GEMM),
    # graphed and eager in alternating pairs
    router = ssm_kernel_router()
    out_k, first_k, s_k, launches, eng, med = _kernel_lane_pairs(
        torch, served, router, "ssm", SSM_KERNEL_RUNS, profile, counters,
        require_packing=False)
    steps = int(s_k["chunk_steps"] + s_k["decode_only_steps"])
    want_mm = 2 * (2 * cfg.n_layers + 1) * int(s_k["chunk_steps"]) + \
        (2 * cfg.n_layers + 1) * int(s_k["decode_only_steps"])
    want_draw = 2 * int(s_k["chunk_steps"]) + int(s_k["decode_only_steps"])
    log(f"[ssm] kernel lanes: launches {launches} over {steps} steps "
        f"({int(s_k['chunk_steps'])} unified, {int(s_k['decode_only_steps'])} "
        "decode-only)")
    if launches != {"matmul_fused": want_mm, "sample_draw": want_draw}:
        raise AssertionError(f"ssm kernel lanes launches {launches}: want GEMM "
                             f"{want_mm}, draw {want_draw}")
    bound_ms, bound_bytes = ssm_decode_bound(cfg, SERVE_RUNTIME["max_slots"])
    dec_ms = _replay_ms(torch, eng._decode_only)
    log(f"[ssm] decode-only step: {dec_ms:.4f} device ms a replay (CUDA events, "
        f"{SSM_DECODE_REPLAYS} replays of the captured graph) against a bytes bound "
        f"of {bound_ms:.4f} ms ({bound_bytes / 1e9:.3f} GB at {HBM_BPS / 1e12:.2f} TB/s); "
        f"{dec_ms / bound_ms:.2f}x the bound")
    del eng

    # 2. torch lanes, graphed: first tokens at the margin
    out_t, first_t, s_t = serve(torch, served, PlanRouter(None), "ssm torch lanes, graphed",
                              profile, require_packing=False)
    div = _first_divergence(out_t, out_k)
    log(f"[ssm] kernel vs torch lanes: first diverging token "
        f"{'none' if div is None else 'request %d token %d: %d vs %d' % div}")
    compare_first_tokens(torch, "ssm kernel lanes", out_k, first_k, out_t, first_t)

    # 3. preemption: 7 usable state rows for 8 slots against run 1 (the
    # unconstrained graphed kernel lanes), bitwise
    commits, held = [], []

    def watch_commits(e):
        ad = e.adapter
        orig = ad.resume_commit

        def resume_commit(group):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                nbytes = orig(group)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            commits.append((sum(nbytes), ad.last_commit_h2d_bytes,
                            _h2d_bytes(prof, 2 * len(group) + 1), len(group), wall))
            return nbytes

        ad.resume_commit = resume_commit
        held.append(e)

    zero()
    out_p, first_p, s_p = serve(torch, served, router, "ssm preempted",
                                require_packing=False, state_slots=SSM_PREEMPT_ROWS,
                                setup=watch_commits)
    pe = held[0]
    sizes = (pe._unified._cache_size(), pe._decode_only._cache_size(),
             pe._commit._cache_size())
    log(f"[ssm] preempted (state_slots {SSM_PREEMPT_ROWS}): "
        f"{int(s_p['preemptions'])} preemptions, {int(s_p['resume_commits'])} resume "
        f"commits; programs (unified, decode-only, commit) {sizes}")
    if not (s_p["preemptions"] >= 1 and s_p["resume_commits"] >= 1):
        raise AssertionError("ssm: the 7-row state pool preempted nothing")
    if sizes != (1, 1, 1):
        raise AssertionError(f"ssm preempted: program signatures {sizes}")
    if out_p != out_k or not _same_firsts(first_p, first_k):
        raise AssertionError(f"ssm: preempted != unconstrained, first divergence "
                             f"{_first_divergence(out_k, out_p)}")
    row_bytes = sum(t.numel() * t.element_size() for t in (pe.cache.conv[:, 0],
                                                            pe.cache.ssm[:, 0]))
    ids_bytes = 4 * pe.adapter.resume_segments
    for swapped, counted, (measured, why), n, wall in commits:
        log(f"[ssm] commit of {n} request(s): swapped {swapped} bytes ({n} x "
            f"{row_bytes} a state row); host-to-device {counted} bytes counted "
            f"(swapped + {counted - swapped} of row ids), {_bytes_note(measured, why)}; "
            f"{1e3 * wall:.2f} ms wall, profiled")
        if swapped != n * row_bytes or counted != swapped + ids_bytes:
            raise AssertionError(f"ssm commit: {counted} bytes != {n} rows + ids")
        if measured is not None and measured != counted:
            raise AssertionError(f"ssm commit: {measured} bytes crossed the bus, "
                                 f"{counted} counted")
    bound = (pe.cache.conv, pe.cache.ssm, *pe.adapter._commit_state)
    rows = np.zeros((pe.adapter.resume_segments,), np.int32)
    ms = time_ms(torch, [lambda: pe._commit(bound, (rows,))], iters=20)
    log(f"[ssm] commit program ms (replays, CUDA events, host staging of the rows "
        f"included): {ms:.4f}; its bytes bound {1e3 * 2 * 4 * row_bytes / HBM_BPS:.4f} "
        f"ms ({pe.adapter.resume_segments} rows read and written)")
    preempt_launches = counts()
    del held[:]

    # 4. the mixed sampling cycle on the graphed kernel lanes
    mix = [_mix(i) for i in range(len(prompts))]
    zero()
    out_s, first_s, s_s = serve(torch, served, router, "ssm sampled, graphed", profile,
                                require_packing=False, samplings=mix)
    sampled = counts()
    out_e, first_e, _ = serve(torch, served, router, "ssm sampled, eager", graphs=False,
                              require_packing=False, samplings=mix)
    if out_e != out_s or not _same_firsts(first_e, first_s):
        raise AssertionError(f"ssm sampled: graphed != eager, first divergence "
                             f"{_first_divergence(out_s, out_e)}")
    greedy_rids = [i + 1 for i, m in enumerate(mix) if m.greedy]
    if any(out_s[r] != out_k[r] for r in greedy_rids):
        raise AssertionError("ssm sampled: a greedy request differs from run 1")
    n_diff = sum(out_s[r] != out_k[r] for r in out_s if r not in greedy_rids)
    want_draw = 2 * int(s_s["chunk_steps"]) + int(s_s["decode_only_steps"])
    log(f"[ssm] sampled: graphed = eager bitwise; the {len(greedy_rids)} greedy "
        f"requests equal run 1's streams; {n_diff} of "
        f"{len(out_s) - len(greedy_rids)} sampled streams differ from greedy; "
        f"launches {sampled}")
    if n_diff == 0 or sampled["sample_draw"] != want_draw:
        raise AssertionError(f"ssm sampled: {n_diff} sampled streams differ, draws "
                             f"{sampled['sample_draw']} (want {want_draw})")

    # 5. the fixed-batch engine at batch 1 (torch lanes, the whole prompt in
    # one SSD scan: lengths <= ssm_chunk or a multiple of it)
    fixed_ids = [i for i, n in enumerate(PROMPT_LENS)
                 if n <= cfg.ssm_chunk or n % cfg.ssm_chunk == 0][:SSM_FIXED_PROMPTS]
    fixed = FixedBatchEngine(served[0], served[1],
                             ServeConfig(batch_size=1, max_seq=SERVE_PLAN["max_seq"],
                                         max_new_tokens=SERVE_RUNTIME["max_new_tokens"]),
                             device=DEVICE)
    for i in fixed_ids:
        fixed.submit(prompts[i])
    t0 = time.perf_counter()
    out_f = {fixed_ids[r.rid - 1] + 1: r.output for r in fixed.run()}
    torch.cuda.synchronize()
    compared = 0
    for rid in sorted(out_f):
        top2 = torch.topk(first_t[rid], 2).values
        margin = float(top2[0] - top2[1])
        div = _first_divergence({rid: out_t[rid]}, {rid: out_f[rid]})
        log(f"[ssm] fixed batch request {rid} ({PROMPT_LENS[rid - 1]} tokens): first "
            f"token {out_f[rid][0]} vs {out_t[rid][0]} continuous torch lanes "
            f"(margin {margin:.3f}), {out_k[rid][0]} kernel lanes; whole stream "
            f"identical to the torch lanes {out_f[rid] == out_t[rid]}, to the kernel "
            f"lanes {out_f[rid] == out_k[rid]}; first diverging token (torch lanes) "
            f"{'none' if div is None else 'index %d: %d vs %d' % div[1:]}")
        if margin > FIRST_TOKEN_MARGIN:
            compared += 1
            if out_f[rid][0] != out_t[rid][0]:
                raise AssertionError(f"ssm fixed batch request {rid}: first token "
                                     f"differs at margin {margin:.3f}")
    log(f"[ssm] fixed batch: {len(out_f)} requests in {time.perf_counter() - t0:.1f} s; "
        f"first tokens agree for {compared}/{len(out_f)} with a top-2 margin > "
        f"{FIRST_TOKEN_MARGIN}")
    if compared == 0:
        raise AssertionError("ssm fixed batch: no first-token margin to compare")

    # 6. the ssm serve plan, raced on the card, then serving under it
    fitness = WallClockFitness(device=DEVICE)
    tuner = Tuner(fitness=fitness)                      # genetic and RL-search
    ssm_plan = dict(SERVE_PLAN, family="ssm")
    zero()
    t0 = time.perf_counter()
    tuned = build_serve_plan(cfg, **ssm_plan, tuner=tuner, dtype="bfloat16")
    torch.cuda.synchronize()
    race = {k: v for k, v in counts().items() if v}
    log(f"build_serve_plan {ssm_plan} bf16: {time.perf_counter() - t0:.2f} s wall; "
        f"fitness calls {fitness.evals}, distinct measurements {fitness.measured}; "
        f"backends {tuned.backend_histogram()}; launches in the race {race}")
    graph = build_serve_graph(cfg, **ssm_plan, dtype="bfloat16")
    if len(graph.toposort()) != 6 or not race.get("matmul_fused"):
        raise AssertionError(f"ssm serve plan: {len(graph.toposort())} nodes, race {race}")
    _log_search(tuner, "ssm serve plan")
    _log_race(graph, tuned, tuner)
    prouter = PlanRouter(tuned)
    log(f"[ssm] lanes: chunk matmuls {prouter.matmul_table('ssm_prefill_chunk')}, "
        f"decode matmuls {prouter.matmul_table('ssm_decode')}")
    zero()
    out_pl, first_pl, s_pl = serve(torch, served, prouter, "ssm tuned plan",
                                   require_packing=False)
    plan_serve = {k: v for k, v in counts().items() if v}
    log(f"[ssm] tokens/s, graphed, this call: tuned plan {s_pl['tokens_per_s']:.1f}, "
        f"kernel lanes {s_k['tokens_per_s']:.1f} (first run; median "
        f"{'n/a' if profile else f'{med[True]:.1f}'}), torch lanes "
        f"{s_t['tokens_per_s']:.1f}")
    want = {"sample_draw"}
    if any(b == "cuda_matmul" for st in ("ssm_prefill_chunk", "ssm_decode")
           for b, _ in prouter.matmul_table(st).values()):
        want.add("matmul_fused")
    log(f"[ssm] launches serving under the tuned plan: {plan_serve}")
    if set(plan_serve) != want:
        raise AssertionError(f"ssm tuned plan launches {plan_serve}: want {want}")
    compare_first_tokens(torch, "ssm tuned plan", out_pl, first_pl, out_t, first_t)

    log(f"[ssm] peak device memory of the phase: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        "(torch.cuda.max_memory_allocated)")
    log(f"[ssm] phase seconds: {time.perf_counter() - t_phase:.1f}")
    return {"serve_mamba2_2_7b": launches, "serve_mamba2_preempted": preempt_launches,
            "serve_mamba2_sampled": sampled, "serve_mamba2_plan_race": race,
            "serve_mamba2_plan_serve": plan_serve}


# ------------------------------------------------------------ phases 8, 9
# qwen2-moe-a2.7b (phase 8, MOE_SERVE_LAYERS of its 24 layers: an earlier
# path, cut for the script's time limit) and granite-3-8b (phase 9, all 40)
# at full width, bf16, random weights from seed 0 drawn on the card one
# layer at a time, served through ContinuousEngine on the paged programs
# with phase 3's runtime (8 slots, 16-token blocks, 256-token chunks of up
# to 4 segments, 32 new tokens): phase 3's 16 prompts over each vocabulary
# (granite: the first 8).
MOE_SERVE_LAYERS = 8
MOE_KERNEL_RUNS = (True, False)                   # one pair
GRANITE_KERNEL_RUNS = (True, False)               # one pair
GRANITE_PROMPTS = 8
DECODE_REPLAYS = 20


def decoder_decode_bound(cfg, lengths):
    """(ms, bytes, weight bytes) of a decode-only step's bytes bound at the
    slots' `lengths`: every weight the step reads once — the bf16
    projections, for the MoE the router, all n_experts' three matrices
    (capacity dispatch runs every expert's (capacity, d) buffer) and the
    shared expert with its gate, the f32 norm scales — the LM head, each
    slot's embedding row, K and V rows up to its length read and its new
    row written, and the bf16 logits written."""
    d, hd, n_layers = cfg.d_model, cfg.hd, cfg.n_layers
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    if cfg.family == "moe":
        wide = cfg.n_shared_experts * cfg.d_expert
        mlp = (d * cfg.n_experts + cfg.n_experts * 3 * d * cfg.d_expert
               + (3 * d * wide + d if wide else 0))
    else:
        mlp = 3 * d * cfg.d_ff
    weights = 2 * (n_layers * (attn + mlp) + d * cfg.vocab)
    norms = 4 * (n_layers * (2 * d + (2 * hd if cfg.qk_norm else 0)) + d)
    slots = len(lengths)
    row = 2 * 2 * n_layers * cfg.n_kv_heads * hd          # K and V, bf16
    total = (weights + norms + 2 * slots * d + row * (sum(lengths) + slots)
             + 2 * slots * cfg.vocab)
    return 1e3 * total / HBM_BPS, total, weights


def _replay_decode(torch, label, cfg, eng):
    """The captured decode-only step of a finished graphed engine: its
    device ms a replay (at the last decode-only step's inputs) against its
    bytes bound there."""
    sig = next(iter(eng._decode_only._signatures.values()))
    lengths = sig.static[1].tolist()
    bound_ms, nbytes, weights = decoder_decode_bound(cfg, lengths)
    ms = _replay_ms(torch, eng._decode_only, DECODE_REPLAYS)
    log(f"[{label}] decode-only step: {ms:.4f} device ms a replay (CUDA events, "
        f"{DECODE_REPLAYS} replays of the captured graph, slot lengths {lengths}) "
        f"against a bytes bound of {bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB at "
        f"{HBM_BPS / 1e12:.2f} TB/s, weights {weights / 1e9:.3f} GB); "
        f"{ms / bound_ms:.2f}x the bound")
    return ms, bound_ms


def _log_block_q(cfg):
    from repro_torch.kernels.attention import PREFILL_MAX_VECTORS, prefill_block_q

    group = cfg.n_heads // cfg.n_kv_heads
    rows = prefill_block_q(PREFILL_BLOCK_Q, SERVE_RUNTIME["chunk_tokens"], group)
    log(f"[{cfg.name}] chunk lane: block_q {PREFILL_BLOCK_Q} at G = {group} "
        f"launches {rows} query rows a CTA, {rows * group} of the tile's "
        f"{PREFILL_MAX_VECTORS} vectors")


def phase_moe(torch, cfg, race_counters, profile=False):
    """qwen2-moe-a2.7b served on the card (see the module docstring, phase
    8).  -> the kernels' launches on each of its paths."""
    from repro_torch.serve.router import PlanRouter

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    served = serving_setup(torch, cfg)
    counters = _serve_counters()
    _log_block_q(cfg)
    router = kernel_lane_router(PREFILL_BLOCK_Q)
    out_k, first_k, _, launches, eng, med = _kernel_lane_pairs(
        torch, served, router, "moe", MOE_KERNEL_RUNS, profile, counters)
    _replay_decode(torch, "moe", cfg, eng)
    del eng

    out_t, first_t, s_t = serve(torch, served, PlanRouter(None), "moe torch lanes, "
                                "graphed", profile)
    div = _first_divergence(out_t, out_k)
    log(f"[moe] kernel vs torch lanes: first diverging token "
        f"{'none' if div is None else 'request %d token %d: %d vs %d' % div}")
    compare_first_tokens(torch, "moe kernel lanes", out_k, first_k, out_t, first_t)

    # preempted vs unconstrained: logged, not gated — capacity grouping
    # takes in the decode batch's idle rows, which preemption changes
    for fn in counters:
        fn.launches = 0
    out_p, first_p, s_p = serve(torch, served, router, "moe preempted",
                                check_schedule=False, num_blocks=PREEMPT_BLOCKS)
    preempted = {fn.__name__: fn.launches for fn in counters}
    div = _first_divergence(out_k, out_p)
    log(f"[moe] preempted ({PREEMPT_BLOCKS}-block pool, {int(s_p['preemptions'])} "
        f"preemptions, {int(s_p['resume_commits'])} resume commits) vs unconstrained: "
        f"whole streams identical for {sum(out_p[r] == out_k[r] for r in out_k)}/"
        f"{len(out_k)}, first-token logits bitwise equal {_same_firsts(first_p, first_k)}; "
        f"first diverging token "
        f"{'none' if div is None else 'request %d token %d: %d vs %d' % div}")
    if not s_p["preemptions"] > 0:
        raise AssertionError("moe: the small pool preempted nothing")

    # the serve plan raced on the card, then the 16 requests under it
    race, plan_serve, _, _ = race_and_serve(torch, served, race_counters, "moe",
                                            (out_t, first_t, s_t), med.get(True))
    log(f"[moe] peak device memory of the phase: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        "(torch.cuda.max_memory_allocated)")
    log(f"[moe] phase seconds: {time.perf_counter() - t_phase:.1f}")
    return {"serve_qwen2_moe": launches, "serve_qwen2_moe_preempted": preempted,
            "serve_qwen2_moe_plan_race": race, "serve_qwen2_moe_plan_serve": plan_serve}


def phase_decoder(torch, cfg, label, path, profile=False, large=False):
    """A dense decoder served on the card on the first GRANITE_PROMPTS
    prompts: granite-3-8b (phase 9), internlm2-20b (phase 17),
    starcoder2-15b (phase 18); see the module docstring.  With `large`
    (phases 17-18) the kernel lanes' streams are also held token by token
    against the dense torch path (`stream_check`; a first token with a
    0.25 margin is not required, at least one token of the two checks is)
    and the launches come back for the graphed and the eager run as two
    paths (the pair's launches are equal).  -> {path: launches}."""
    from repro_torch.serve.router import PlanRouter

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    served = serving_setup(torch, cfg)
    prompts = served[2][:GRANITE_PROMPTS]
    _log_block_q(cfg)
    out_k, first_k, _, launches, eng, _ = _kernel_lane_pairs(
        torch, served, kernel_lane_router(PREFILL_BLOCK_Q), label,
        GRANITE_KERNEL_RUNS, profile, _serve_counters(), prompts=prompts)
    _replay_decode(torch, label, cfg, eng)
    del eng
    out_t, first_t, _ = serve(torch, served, PlanRouter(None),
                              f"{label} torch lanes, graphed", profile, prompts=prompts)
    div = _first_divergence(out_t, out_k)
    log(f"[{label}] kernel vs torch lanes: first diverging token "
        f"{'none' if div is None else 'request %d token %d: %d vs %d' % div}")
    compared = compare_first_tokens(torch, f"{label} kernel lanes", out_k, first_k,
                                    out_t, first_t, require=not large)
    if large and compared + stream_check(torch, label, served[0], served[1], prompts,
                                         out_k)[0] == 0:
        raise AssertionError(f"[{label}] no token had a margin to compare")
    log(f"[{label}] peak device memory of the phase: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        "(torch.cuda.max_memory_allocated)")
    log(f"[{label}] phase seconds: {time.perf_counter() - t_phase:.1f}")
    if large:
        return {f"{path}_graphed": launches, f"{path}_eager": dict(launches)}
    return {path: launches}


# ------------------------------------------------------------ phases 11-13
# The three remaining families at full width and depth, bf16, random
# weights from seed 0 drawn on the card by `init_serving`: qwen2-vl-2b
# (phase 11) on the paged programs with phase 3's 16 prompts and runtime,
# then with its 256 vision embeddings on the fixed-batch loop;
# zamba2-1.2b (phase 12) and whisper-base (phase 13, with 1500 audio
# frames) on the fixed-batch loop, the only engine their families have,
# in the reference too.  The loop runs PyTorch ops and the draw kernel: no
# plan reaches it.  The fixed-batch runs are held against the same
# parameters cast up to f32 (only the arithmetic differs), token by token
# on the bf16 run's history, wherever the f32 top-2 margin exceeds
# FIRST_TOKEN_MARGIN (`f32_check`).
VLM_KERNEL_RUNS = (True, False)                   # one pair
FIXED_BATCH = 4
VLM_FIXED_LENS = (300, 340, 370, 400)
VLM_FIXED_SEQ = 512
HYBRID_FIXED_LENS = (32, 64, 96, 128, 160, 192, 224, 256)
HYBRID_FIXED_SEQ = 512
ENCDEC_FIXED_LENS = (4, 12, 20, 28, 36, 44, 52, 64)
ENCDEC_FIXED_SEQ = 128


def family_setup(torch, cfg):
    """A model of the hybrid or encdec family at full width and depth
    (random weights from seed 0, drawn on the card by `init_serving`)."""
    from repro_torch.models import build_model

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_serving(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    heads = f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.hd}, " if cfg.n_heads else ""
    log(f"model {cfg.name} ({type(model).__name__}): {cfg.n_layers} layers"
        f"{f' + {cfg.n_enc_layers} encoder layers' if cfg.n_enc_layers else ''}, "
        f"d_model {cfg.d_model}, {heads}"
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        f"{sum(t.numel() for t in leaves) / 1e9:.3f} G params "
        f"({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB) "
        f"initialised on the card in {time.perf_counter() - t0:.1f} s")
    return model, params


def fixed_serve(torch, model, params, prompts, label, max_seq, extras=None,
                loop=False, mesh=None, rules=None):
    """Serve `prompts` through `ServeEngine`, which must route them to the
    fixed-batch loop (the family has no paged path, or extras ride along),
    or with `loop` through `FixedBatchEngine` itself (on `mesh` under
    `rules` where given); batches of
    FIXED_BATCH, left-padded, 32 new tokens.  Every request must finish
    with in-vocabulary tokens and finite first-token logits.
    -> ({rid: tokens}, {rid: first-token logits, f32 on the host},
    decode tokens/s, prefill seconds)."""
    from repro_torch.serve.engine import FixedBatchEngine, ServeConfig, ServeEngine

    cfg = model.cfg
    scfg = ServeConfig(batch_size=FIXED_BATCH, max_seq=max_seq,
                       max_new_tokens=SERVE_RUNTIME["max_new_tokens"])
    if loop:
        eng = FixedBatchEngine(model, params, scfg, extras, device=DEVICE, mesh=mesh,
                               rules=rules)
    else:
        eng = ServeEngine(model, params, scfg, extras=extras, device=DEVICE)
        if not isinstance(eng._engine, FixedBatchEngine):
            raise AssertionError(f"[{label}] ServeEngine did not route to the loop")
    rows = []

    def prefill(p, batch, n):            # records each batch's first logits
        logits, cache = type(model).prefill(model, p, batch, n)
        rows.append(logits[:, -1].to("cpu", torch.float32))
        return logits, cache

    model.prefill = prefill
    try:
        for p in prompts:
            eng.submit(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del model.prefill
    firsts = torch.cat(rows)                  # batch after batch, FIXED_BATCH rows
    out = {r.rid: r.output for r in done}
    first = {rid: firsts[rid - 1] for rid in out}
    if len(done) != len(prompts):
        raise AssertionError(f"[{label}] {len(done)} of {len(prompts)} finished")
    for rid, toks in out.items():
        if len(toks) != scfg.max_new_tokens or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"[{label}] request {rid}: bad stream")
        if not bool(torch.isfinite(first[rid]).all()):
            raise AssertionError(f"[{label}] request {rid}: non-finite logits")
    st = eng.stats
    tps = eng.throughput()
    log(f"[{label}] {st['requests']} requests in batches of {FIXED_BATCH}, "
        f"{st['tokens_out']} tokens: {tps:.1f} tokens/s (throughput(): tokens "
        f"over decode seconds), prefill {st['prefill_s']:.3f} s, decode "
        f"{st['decode_s']:.3f} s, wall {wall:.3f} s")
    return out, first, tps, st["prefill_s"]


def teacher_forced_rows(torch, model, params, prompts, max_seq, out, extras=None):
    """The fixed-batch loop's logit rows on its own greedy tokens `out`
    ({rid: tokens}), teacher-forced: each batch of FIXED_BATCH prompts
    left-padded as the loop pads them, then each decode step fed the
    tokens `out` drew.  -> [(rid, token index, f32 logit row on the
    host)], batch by batch, step by step."""
    import numpy as np

    from repro_torch.launch import steps

    ex = {k: torch.as_tensor(v, device=DEVICE).expand(FIXED_BATCH, *v.shape)
          for k, v in (extras or {}).items()}
    n_new = SERVE_RUNTIME["max_new_tokens"]
    rows = []
    for b0 in range(0, len(prompts), FIXED_BATCH):
        batch = prompts[b0:b0 + FIXED_BATCH]
        rids = list(range(b0 + 1, b0 + 1 + len(batch)))
        plen = max(len(p) for p in batch)
        toks = np.zeros((FIXED_BATCH, plen), np.int32)
        drawn = np.zeros((FIXED_BATCH, n_new), np.int32)
        for i, (p, rid) in enumerate(zip(batch, rids)):
            toks[i, plen - len(p):] = p                   # left-pad
            drawn[i] = out[rid]
        logits, cache = steps.prefill_step(model, params,
                                           torch.as_tensor(toks, device=DEVICE),
                                           max_seq, ex)
        for j in range(n_new):
            step_rows = logits[:, -1].to("cpu", torch.float32)
            rows += [(rid, j, step_rows[i]) for i, rid in enumerate(rids)]
            if j + 1 < n_new:
                logits, cache = steps.serve_step(
                    model, params, cache, torch.as_tensor(drawn[:, j:j + 1], device=DEVICE))
    torch.cuda.synchronize()
    return rows


def margin_agree(label, rows, out, what):
    """Every token of `out` must be its replayed row's argmax wherever
    that row's top-2 margin exceeds FIRST_TOKEN_MARGIN.  -> (first tokens
    compared, tokens compared)."""
    torch = sys.modules["torch"]
    n_first = n_all = 0
    for rid, j, row in rows:
        top2 = torch.topk(row, 2)
        margin = float(top2.values[0] - top2.values[1])
        if margin <= FIRST_TOKEN_MARGIN:
            continue
        n_first += j == 0
        n_all += 1
        if int(top2.indices[0]) != out[rid][j]:
            raise AssertionError(
                f"[{label}] request {rid} token {j}: {out[rid][j]} vs "
                f"{int(top2.indices[0])} on {what} at margin {margin:.3f}")
    return n_first, n_all


def f32_check(torch, label, model, params, prompts, max_seq, out, first,
              extras=None):
    """The bf16 fixed-batch run `out` (greedy) against the same parameters
    cast up to f32 (only the arithmetic differs), teacher-forced
    (`teacher_forced_rows`).  Every token the bf16 run drew — its first
    tokens and each decode step's — must be the f32 twin's argmax on the
    same history wherever the twin's top-2 margin exceeds
    FIRST_TOKEN_MARGIN (the random models' margins are often smaller; a
    run where no token has one fails).  -> the max |logit difference| at
    the first tokens."""
    import dataclasses

    twin = type(model)(dataclasses.replace(model.cfg, dtype="float32"))
    tparams = twin.serving_params(params, DEVICE)
    t0 = time.perf_counter()
    rows = teacher_forced_rows(torch, twin, tparams, prompts, max_seq, out, extras)
    max_err = max((first[rid] - row).abs().max().item() for rid, j, row in rows if j == 0)
    n_first, n_all = margin_agree(label, rows, out, "the f32 twin")
    log(f"[{label}] against the f32 twin (teacher-forced, {time.perf_counter() - t0:.1f} s): "
        f"first tokens {n_first}/{len(out)} compared (top-2 margin > "
        f"{FIRST_TOKEN_MARGIN}), every token {n_all}/{len(rows)} compared, all agree; "
        f"max |logit difference| at the first tokens {max_err:.4f}")
    if n_all == 0:
        raise AssertionError(f"[{label}] no token had a margin to compare")
    return max_err


def _fmt_div(div):
    return "none" if div is None else "request %d token %d: %d vs %d" % div


def _zeroed(counters):
    for fn in counters:
        fn.launches = 0


def _launched(counters):
    return {fn.__name__: fn.launches for fn in counters if fn.launches}


def _fixed_and_f32(torch, model, params, prompts, label, max_seq, counters,
                   extras=None):
    """The fixed-batch run (its launches counted: the draw kernel only),
    then `f32_check`.  -> (launches, streams, first-token logits)."""
    _zeroed(counters)
    out, first, tps, prefill_s = fixed_serve(torch, model, params, prompts, label,
                                             max_seq, extras)
    launches = _launched(counters)
    if set(launches) != {"sample_draw"}:
        raise AssertionError(f"[{label}] launches {launches}: want the draw kernel only")
    f32_check(torch, label, model, params, prompts, max_seq, out, first, extras)
    log(f"[{label}] launches {launches}; tokens/s {tps:.1f}, prefill {prefill_s:.3f} s")
    return launches, out, first


def _phase_end(label, t_phase):
    torch = sys.modules["torch"]
    log(f"[{label}] peak device memory of the phase: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        "(torch.cuda.max_memory_allocated)")
    log(f"[{label}] phase seconds: {time.perf_counter() - t_phase:.1f}")


def phase_vlm(torch, cfg, profile=False):
    """qwen2-vl-2b served on the card (see the module docstring, phase
    11).  -> the kernels' launches on its two paths."""
    import numpy as np

    from repro_torch.serve.router import PlanRouter

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    served = serving_setup(torch, cfg)
    model, params, prompts = served
    _log_block_q(cfg)
    router = kernel_lane_router(PREFILL_BLOCK_Q)
    counters = _serve_counters()
    out_k, first_k, _, launches, eng, _ = _kernel_lane_pairs(
        torch, served, router, "qwen2-vl", VLM_KERNEL_RUNS, profile, counters)
    _replay_decode(torch, "qwen2-vl", cfg, eng)
    del eng
    out_t, first_t, _ = serve(torch, served, PlanRouter(None),
                              "qwen2-vl torch lanes, graphed", profile)
    log(f"[qwen2-vl] kernel vs torch lanes: first diverging token "
        f"{_fmt_div(_first_divergence(out_t, out_k))}")
    compare_first_tokens(torch, "qwen2-vl kernel lanes", out_k, first_k, out_t, first_t)

    few = prompts[:IDENTITY_PROMPTS]
    out_p, first_p, s_p = serve(torch, served, router, "qwen2-vl preempted",
                                prompts=few, check_schedule=False,
                                num_blocks=PREEMPT_BLOCKS)
    out_u, first_u, _ = serve(torch, served, router, "qwen2-vl unconstrained",
                              prompts=few, check_schedule=False)
    if not s_p["preemptions"] > 0:
        raise AssertionError("qwen2-vl: the small pool preempted nothing")
    if out_p != out_u or not _same_firsts(first_p, first_u):
        raise AssertionError(f"qwen2-vl: preempted != unconstrained, first divergence "
                             f"{_first_divergence(out_u, out_p)}")
    log(f"[qwen2-vl] preempted ({PREEMPT_BLOCKS}-block pool, {int(s_p['preemptions'])} "
        f"preemptions) = unconstrained, bitwise (streams, first-token logits)")

    # the fixed-batch loop with the vision embeddings
    rng = np.random.default_rng(1)
    vision = rng.standard_normal((cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    fixed_prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
                     for n in VLM_FIXED_LENS]
    extras = {"vision_embeds": vision}
    fixed, _, first_v = _fixed_and_f32(
        torch, model, params, fixed_prompts, "qwen2-vl fixed batch, vision",
        VLM_FIXED_SEQ, counters, extras)
    _, first_x, _, _ = fixed_serve(torch, model, params, fixed_prompts,
                                   "qwen2-vl fixed batch, text only", VLM_FIXED_SEQ,
                                   loop=True)
    moved = min((first_v[r] - first_x[r]).abs().max().item() for r in first_v)
    log(f"[qwen2-vl] the vision embeddings move every request's first-token logits "
        f"(smallest max |difference| {moved:.4f})")
    if not moved > 0:
        raise AssertionError("qwen2-vl: the vision embeddings did not reach the model")
    _phase_end("qwen2-vl", t_phase)
    return {"serve_qwen2_vl_2b": launches, "fixed_qwen2_vl_2b_vision": fixed}


def phase_fixed_family(torch, cfg, lens, max_seq, label, path, extras_key=None):
    """zamba2-1.2b (phase 12) or whisper-base (phase 13, with `extras_key`
    "audio_embeds": enc_seq frames drawn from the seed) served on the
    fixed-batch loop (see the module docstring). -> the draw kernel's
    launches on its path."""
    import numpy as np

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, params = family_setup(torch, cfg)
    rng = np.random.default_rng(2)
    extras = None
    if extras_key:
        extras = {extras_key: rng.standard_normal((cfg.enc_seq, cfg.d_model)
                                                  ).astype(np.float32)}
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in lens]
    launches, _, _ = _fixed_and_f32(torch, model, params, prompts,
                                       f"{label} fixed batch", max_seq,
                                       _serve_counters(), extras)
    _phase_end(label, t_phase)
    return {path: launches}


def free_device(torch):
    """Drop what the last phase left (engines and their captured graphs, a
    model) before the next one loads a model."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory after freeing: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "allocated")


# -------------------------------------------------------------- phase 4
# The paper's pipeline on ResNet-18 (batch 1, 3x224x224, f32, random
# weights from seed 0): optimize_graph, select twice on wall-clock fitness
# (the full race against cuDNN / cuBLAS, and the WPK-only ablation), then
# the Engine under each plan.  Both plans are held to the vendor lane of
# the same graph (TF32 off) at WPK_TOL: f32 with the summation order of
# every conv changed, ~1e-5 relative over 20 layers expected; 1e-3 is far
# above that and far below what a padding or layout fault gives.
WPK_TOL = 1e-3
FORWARD_REPEATS = 50
WPK_IMAGE = 224


def _forward_ms(torch, engines, x, repeats=FORWARD_REPEATS, warmup=3):
    """{label: median ms of one forward}, CUDA events around each forward;
    the engines take turns forward by forward, so drift in clocks or host
    load falls on all of them alike."""
    for _ in range(warmup):
        for eng in engines.values():
            eng(x)
    torch.cuda.synchronize()
    pairs = {label: [] for label in engines}
    for _ in range(repeats):
        for label, eng in engines.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            eng(x)
            end.record()
            pairs[label].append((start, end))
    torch.cuda.synchronize()
    out = {}
    for label, ps in pairs.items():
        times = sorted(s.elapsed_time(e) for s, e in ps)
        out[label] = times[len(times) // 2]
    return out


def phase_wpk(torch, profile=False):
    from repro_torch.core import (Engine, Tuner, WallClockFitness, default_registry,
                                  op_desc_of, optimize_graph, ref_ops, roofline_bound,
                                  select)
    from repro_torch.kernels import conv2d as KC
    from repro_torch.kernels import fused as KF
    from repro_torch.kernels import matmul as KM
    from repro_torch.models.resnet import resnet18_graph

    g = resnet18_graph(batch=1, image=WPK_IMAGE, seed=0)
    t0 = time.perf_counter()
    gopt = optimize_graph(g)
    log(f"optimize_graph: {time.perf_counter() - t0:.2f} s; {gopt.op_histogram()}")
    fitness = WallClockFitness(device=DEVICE)
    tuner = Tuner(fitness=fitness)                      # genetic and RL-search
    counters = (KC.conv2d_direct, KM.matmul_fused, KF.fused_elementwise)
    for fn in counters:
        fn.launches = 0
    plans = {}
    for label, third_party in (("race", True), ("wpk_only", False)):
        t0 = time.perf_counter()
        plans[label] = select(gopt, tuner=tuner, dtype="float32", third_party=third_party)
        log(f"select third_party={third_party}: {time.perf_counter() - t0:.2f} s wall; "
            f"backends {plans[label].backend_histogram()}; fitness calls "
            f"{fitness.evals}, distinct measurements {fitness.measured} so far")
    race = {fn.__name__: fn.launches for fn in counters if fn.launches}
    log(f"launches in the race (both selects): {race}")
    _log_search(tuner, "resnet18")

    # the per-group race (paper Figure 2b): one row per distinct operator
    groups = {op.dims: name for name, op, _ in resnet_conv_shapes()}
    rows = {}
    for node in gopt.nodes:
        op = op_desc_of(gopt, node, "float32")
        if op is None:
            continue
        key = op.signature()
        if key not in rows:
            c = plans["race"].choices[node.name]
            rows[key] = [groups.get(op.dims, op.kind), op, c, 0]
        rows[key][3] += 1
    log("per operator: group, shape, act, nodes, vendor ms, kernel ms (config), "
        "winner, bound ms (f32 peak)")
    for name, op, c, count in rows.values():
        d = op.d
        shape = (f"{d['h']}x{d['w']}x{d['cin']}->{d['cout']} k{d['kh']}/s{d['stride']}"
                 if op.kind == "conv2d" else f"{d['m']}x{d['k']}->{d['n']}")
        kname = "pallas_conv2d" if op.kind == "conv2d" else "pallas_matmul"
        cfg = plans["wpk_only"].choices[op.label].config
        log(f"  {name:4s} {shape:26s} act={op.activation} x{count}: vendor "
            f"{1e3 * c.candidates['xla']:.4f} kernel {1e3 * c.candidates[kname]:.4f} "
            f"({cfg}) winner {c.backend} bound {1e3 * roofline_bound(op):.4f}")
    # what laying the vendor lane's conv weights out once saves: each
    # operator's vendor lane re-timed now, with the laid-out weight and with
    # the graph's HWIO weight that PyTorch copies to channels_last per call
    vendor_sum = [0.0, 0.0]
    for name, op, c, count in rows.values():
        if op.kind != "conv2d":
            continue
        attrs = {"stride": op.d["stride"], "layout": "NHWC", "activation": op.activation,
                 "padding": "SAME" if op.d["pad"] else "VALID"}
        laid = fitness.time(fitness.vendor_runner(op))
        hwio = fitness.time([lambda c=c: ref_ops.run_op("fused_conv2d", list(c), attrs)
                             for c in fitness.inputs(op)])
        vendor_sum[0] += count * laid
        vendor_sum[1] += count * hwio
    log(f"vendor lane, 20 convs of a forward, device time: weights laid out once "
        f"{1e3 * vendor_sum[0]:.4f} ms, HWIO weights converted per call "
        f"{1e3 * vendor_sum[1]:.4f} ms")

    x = torch.randn((1, 3, WPK_IMAGE, WPK_IMAGE),
                    generator=torch.Generator(device=DEVICE).manual_seed(6), device=DEVICE)
    reg = default_registry()
    # the same lanes without the registry's fused_elementwise entry: the
    # engine then runs its 8 residual chains on ref_ops (add, then relu),
    # as it did before it had the route
    reg_ref = {k: v for k, v in reg.items() if k != "fused_elementwise"}
    # each engine's forward captured in a CUDA graph (its first call), and
    # the two plans also eagerly, to compare against
    engines = {"torch lanes (no plan), graphed": Engine(gopt, None, None, device=DEVICE)}
    for label, plan in (("race plan", plans["race"]), ("WPK-only plan", plans["wpk_only"])):
        for graphed in (True, False):
            engines[f"{label}, {'graphed' if graphed else 'eager'}"] = Engine(
                gopt, plan, reg, device=DEVICE, cuda_graph=graphed)
        engines[f"{label}, graphed, chains on ref_ops"] = Engine(
            gopt, plan, reg_ref, device=DEVICE)
    for eng in engines.values():
        eng(x)                                   # graphed: warm-up, capture
    for label in ("race plan", "WPK-only plan"):
        graphed, eager = engines[f"{label}, graphed"], engines[f"{label}, eager"]
        got, want = graphed(x)[0], eager(x)[0]  # a replay; an eager forward
        if not torch.equal(got, want):
            raise AssertionError(f"[{label}] graphed forward differs from eager: "
                                 f"{(got - want).abs().max().item()}")
        if (graphed._program.captures, graphed._program.replays) != (1, 1) or \
                eager._program.captures:
            raise AssertionError(f"[{label}] captures / replays wrong")
        log(f"[{label}] graphed forward (a replay) bitwise equal to the eager one; "
            "one capture")
        unrouted = engines[f"{label}, graphed, chains on ref_ops"](x)[0]
        if not torch.equal(got, unrouted):
            raise AssertionError(f"[{label}] chains on the fused kernel differ from "
                                 f"chains on ref_ops: {(got - unrouted).abs().max().item()}")
        log(f"[{label}] forward with its 8 chains on the fused kernel bitwise equal to "
            "the same plan with the chains on ref_ops (f32 add, then relu, rounds alike)")
        for lane in ("graphed", "eager"):
            err = engines[f"{label}, {lane}"].verify_against_reference(
                x, rtol=WPK_TOL, atol=WPK_TOL)
            log(f"[{label}, {lane}] verify_against_reference: max |err| {err:.3e} "
                f"(rtol = atol = {WPK_TOL:.0e}) ok")
    ref_unopt = Engine(g, None, None, device=DEVICE, cuda_graph=False)(x)[0]

    # the main path: one forward under the WPK-only plan (the convs and the
    # fc on the conv kernel and the GEMM, the 8 residual chains on the
    # fused kernel), eagerly and replayed from its CUDA graph
    for fn in counters:
        fn.launches = 0
    env = engines["WPK-only plan, eager"].run_env(x)
    torch.cuda.synchronize()
    forward = {fn.__name__: fn.launches for fn in counters}
    for fn in counters:
        fn.launches = 0
    engines["WPK-only plan, graphed"](x)        # a replay: the launches it captured
    torch.cuda.synchronize()
    graphed = {fn.__name__: fn.launches for fn in counters}
    fused_nodes = [n for n in gopt.nodes if n.op == "fused_elementwise"]
    log(f"launches on the WPK-only forward: {forward} eager, {graphed} replayed "
        f"from its CUDA graph ({len(fused_nodes)} fused_elementwise nodes)")
    want = {"conv2d_direct": 20, "matmul_fused": 1, "fused_elementwise": 8}
    if forward != want or graphed != want or len(fused_nodes) != 8:
        raise AssertionError(f"launches {forward} eager / {graphed} replayed: want {want}")
    logits = env[gopt.outputs[0]]
    if logits.shape != (1, 1000) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    d_unopt = (logits - ref_unopt).abs().max().item()
    if not d_unopt <= WPK_TOL * max(1.0, ref_unopt.abs().max().item()):
        raise AssertionError(f"optimized graph vs unoptimized: {d_unopt}")
    log(f"logits (1, 1000) finite; WPK-only vs the unoptimized graph on the "
        f"torch lanes: max |diff| {d_unopt:.3e} (max |logit| "
        f"{ref_unopt.abs().max().item():.3f})")

    forward_ms = {}
    if not profile:
        forward_ms = _forward_ms(torch, engines, x)
        for label, ms in forward_ms.items():
            log(f"[{label}] one forward: {ms:.4f} ms/image (median of {FORWARD_REPEATS}, "
                "CUDA events, lanes in turn)")
    if profile:
        from torch.profiler import ProfilerActivity
        for label, eng in engines.items():
            with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(FORWARD_REPEATS):
                    eng(x)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            _log_device_profile(prof, wall, f"{label}, {FORWARD_REPEATS} forwards",
                                calls=FORWARD_REPEATS)
    return {"wpk_resnet18_race": race, "wpk_resnet18_forward": forward,
            "wpk_resnet18_forward_graphed": graphed}, plans["race"], fitness


# ------------------------------------------------------------ phase 26
# The port's examples (`repro_torch.examples`, ROADMAP item 10a) in this
# process, at their JAX examples' sizes, on the card, right after phase 4:
# quickstart (its graph, optimize_graph, a genetic Tuner on device time,
# select, the Engine with default_registry(), verify_against_reference),
# tune_resnet18 (ResNet-18's 11 conv groups at batch 1, 224, bf16, the
# genetic Tuner on phase 4's WallClockFitness, the vendor lane cuDNN, the
# warm-cache re-tune) and serve_inference (reduced qwen3 trained 30 steps,
# the serve plan tuned by random search on device time, 12 requests
# through ContinuousEngine).  Each one's output is logged, its
# hand-written launches counted as a path of its own.
EXAMPLE_REQUESTS = 12


def phase_examples(torch, fitness):
    """Phase 26 (see the comment above); `fitness`: phase 4's device-time
    fitness, handed to tune_resnet18 so that no measurement repeats."""
    import contextlib
    import io

    from repro_torch.examples import quickstart, serve_inference, tune_resnet18
    from repro_torch.models.resnet import conv_groups

    label = "examples"
    t_phase = time.perf_counter()
    wrappers = _wrappers()
    paths, out = {}, {}
    for name, call in (("quickstart", lambda: quickstart.main([])),
                       ("tune_resnet18", lambda: tune_resnet18.main([], fitness=fitness)),
                       ("serve_inference", lambda: serve_inference.main([]))):
        _zeroed(wrappers)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out[name] = call()
        torch.cuda.synchronize()
        for line in buf.getvalue().splitlines():
            log(f"[{label} {name}] {line}")
        paths[f"example_{name}"] = {fn.__name__: fn.launches for fn in wrappers}
        log(f"[{label} {name}] {time.perf_counter() - t0:.1f} s; hand-written launches "
            f"{_launched(wrappers) or 'none'}")
    q, t, s = out["quickstart"], out["tune_resnet18"], out["serve_inference"]
    groups = conv_groups(1, 224)
    if not q["max_err"] <= 2e-2:
        raise AssertionError(f"[{label}] quickstart's engine error {q['max_err']:.3e}")
    if [r[0] for r in t["rows"]] != [n for n, _ in groups] or t["hits"] != len(groups):
        raise AssertionError(f"[{label}] tune_resnet18: {len(t['rows'])} rows, "
                             f"{t['hits']} warm hits for {len(groups)} groups")
    if not s["served"] == s["correct"] == EXAMPLE_REQUESTS:
        raise AssertionError(f"[{label}] serve_inference: {s['correct']}/{s['served']} "
                             "requests continued the sequence")
    log(f"[{label}] quickstart's engine within {q['max_err']:.2e} of the vendor lane; "
        f"tune_resnet18 one row a group ({len(groups)}), the warm re-tune all hits; "
        f"serve_inference {s['correct']}/{s['served']} exact")
    _phase_end(label, t_phase)
    return paths


# ------------------------------------------------------------ phase 10
# The analytic fitness (`core/costmodel.py::ModelFitness`) against the
# card, configuration by configuration: every valid configuration of each
# distinct operator of ResNet-18 (batch 1, 224, f32: its 15 convs' and the
# fc's), of qwen3-1.7b's serve graph (12 matmul and 3 attention nodes,
# bf16) and of mamba2-2.7b's (6 matmul nodes), each held against its plain
# version, timed by device-time fitness (CUDA-graph replay) and priced by
# the model; the vendor lane both ways.  Logged, not gated: Spearman's rho,
# the regret of the model's pick, the backend agreement, model / measured at
# the measured best.  Gated: every configuration launched, finite and
# within its tolerance; the model at or above `kernel_bound` everywhere.
def _ranks(xs):
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    ranks, i = [0.0] * len(xs), 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        for t in range(i, j + 1):
            ranks[order[t]] = (i + j) / 2       # ties share their mean rank
        i = j + 1
    return ranks


def spearman(a, b):
    """Spearman's rho of two sequences (nan where either is constant)."""
    ra, rb = _ranks(a), _ranks(b)
    n = len(ra)
    ma, mb = sum(ra) / n, sum(rb) / n
    cov = sum((x - ma) * (y - mb) for x, y in zip(ra, rb))
    va, vb = sum((x - ma) ** 2 for x in ra), sum((y - mb) ** 2 for y in rb)
    return cov / math.sqrt(va * vb) if va > 0 and vb > 0 else float("nan")


def _plain_and_tol(op, x, w, b):
    """The kernel lane's plain version on the fitness's inputs, and its
    tolerance (phase 2's)."""
    from repro_torch.kernels import ref as R

    if op.kind == "attention":
        return R.attention_ref(x, w, b, True), ATT_TOL_F32MATH_BF16
    if op.kind == "conv2d":
        want = R.conv2d_ref(x, w, b, op.d["stride"], "SAME" if op.d["pad"] else "VALID",
                            op.activation)
        rtol = CONV_RTOL_F32 if op.dtype == "float32" else CONV_RTOL_BF16
    else:
        want = R.matmul_ref(x, w, b, op.activation)
        rtol = MM_RTOL_F32 if op.dtype == "float32" else MM_RTOL_BF16
    return want, _rel_tol(rtol, want)


def _fit_operator(torch, op, fitness, model, chk):
    """One operator's whole space measured and modeled (see above)."""
    from repro_torch.core.costmodel import UNPRICED_KEYS, kernel_bound
    from repro_torch.core.schedules import templates_for

    tmpl = templates_for(op)[0]
    configs = []
    for cfg in tmpl.enumerate_configs(op):
        read = {k: v for k, v in cfg.items() if k not in UNPRICED_KEYS}
        if read not in configs:
            configs.append(read)
    x, w, b = fitness.inputs(op)[0]
    want, tol = _plain_and_tol(op, x, w, b)
    bound = kernel_bound(op)
    measured, modeled = [], []
    for cfg in configs:
        out = fitness.kernel_runner(op, cfg)[0]()
        err = (out.float() - want.float()).abs().max().item()
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"{op.label} {cfg}: error {err} > tol {tol}")
        chk.err = max(chk.err, err)
        t = fitness(op, cfg)
        if not (math.isfinite(t) and t > 0):
            raise AssertionError(f"{op.label} {cfg}: measured {t}")
        measured.append(t)
        modeled.append(model(op, cfg))
        if modeled[-1] < bound:
            raise AssertionError(f"{op.label} {cfg}: model {modeled[-1]} < bound {bound}")
    del want
    best = min(range(len(configs)), key=lambda i: measured[i])
    pick = min(range(len(configs)), key=lambda i: modeled[i])
    vendor, vendor_model = fitness.vendor_time(op), model.vendor_time(op)
    race = "kernel" if measured[best] < vendor else "vendor"
    race_model = "kernel" if modeled[pick] < vendor_model else "vendor"
    row = {"label": op.label, "configs": len(configs),
           "rho": spearman(modeled, measured) if len(configs) > 1 else float("nan"),
           "regret": measured[pick] / measured[best],
           "agree": race == race_model, "race": race, "race_model": race_model,
           "ratio": modeled[best] / measured[best],
           "vendor_ratio": vendor_model / vendor}
    log(f"  {op.label} {op.signature()}: per config, measured / modeled ms: " + "; ".join(
        f"{json.dumps(c, sort_keys=True)} {1e3 * t:.4f} / {1e3 * mt:.4f}"
        for c, t, mt in zip(configs, measured, modeled)))
    log(f"  {op.label:28s} {op.kind:9s} {len(configs):3d} configs: rho {row['rho']:+.3f}; "
        f"model pick {configs[pick]} {1e3 * measured[pick]:.4f} ms vs measured best "
        f"{configs[best]} {1e3 * measured[best]:.4f} ms (regret {row['regret']:.3f}); "
        f"model / measured at the best {row['ratio']:.2f}; vendor measured "
        f"{1e3 * vendor:.4f} model {1e3 * vendor_model:.4f} ms; race {race}, model "
        f"{race_model} ({'agree' if row['agree'] else 'DISAGREE'}); bound "
        f"{1e3 * bound:.4f} ms")
    return row


def _fit_summary(label, rows):
    def stats(key, worst):
        vals = sorted(r[key] for r in rows if math.isfinite(r[key]))
        if not vals:
            return "n/a"
        return f"median {_median(vals):.3f} worst {worst(vals):.3f}"
    ratios = [r["ratio"] for r in rows]
    log(f"[fitness {label}] {len(rows)} operators, "
        f"{sum(r['configs'] for r in rows)} configurations: rho {stats('rho', min)}; "
        f"regret {stats('regret', max)}; backend agreement "
        f"{sum(r['agree'] for r in rows)}/{len(rows)}; model / measured at the "
        f"measured best median {_median(sorted(ratios)):.3f} range "
        f"{min(ratios):.3f}-{max(ratios):.3f}")


def _log_model_at_records():
    """The model at the shapes whose device times phase 2 measures (PERF.md
    §6 rows 3, 4, 6 and the row-3 table): the GEMM's default geometry and
    one torch.matmul (+ silu at mlp_up), the conv at each group's
    fastest modeled configuration and F.conv2d + relu, the flash kernel at
    its default tile on the race's MHA-shaped K/V."""
    from repro_torch.configs import get_config
    from repro_torch.core import costmodel as C
    from repro_torch.core.schedules import TEMPLATES, OpDesc

    def gemm(m, k, n, act, dtype="bfloat16"):
        op = OpDesc.matmul(m, n, k, dtype=dtype, activation=act)
        lib = C.cublas_time(m, n, k, dtype) + (
            C.elementwise_time(2 * m * n * 2) if act else 0.0)
        return 1e3 * C.kernel_time(op, {}), 1e3 * lib

    for name, gemms in (("qwen3-1.7b", serving_gemms(get_config("qwen3-1.7b"))),
                        ("granite-3-8b", serving_gemms(get_config("granite-3-8b"))),
                        ("qwen2-moe-a2.7b", moe_gemms(get_config("qwen2-moe-a2.7b")))):
        for m in (8, 256):
            rows = [(role, *gemm(m, k, n, act)) for role, k, n, act in gemms]
            log(f"[model at records] {name} GEMM M={m}, kernel / library ms: "
                + "; ".join(f"{r} {a:.4f} / {b:.4f}" for r, a, b in rows)
                + f"; sum {sum(a for _, a, _ in rows):.4f} / {sum(b for _, _, b in rows):.4f}")
    rows = [(f"{lane} {role} M={m}", *gemm(m, k, n, None))
            for lane, role, m, k, n in ssm_gemms(get_config("mamba2-2.7b"))]
    log("[model at records] mamba2-2.7b GEMM, kernel / library ms: "
        + "; ".join(f"{r} {a:.4f} / {b:.4f}" for r, a, b in rows))
    log("[model at records] ResNet-18 fc (M=1, K=512, N=1000, f32), kernel / library "
        "ms: %.4f / %.4f" % gemm(1, 512, 1000, None, "float32"))
    tmpl, kernel, library = TEMPLATES["pallas_conv2d"], 0.0, 0.0
    for _, op, count in resnet_conv_shapes():
        op = OpDesc.make("conv2d", op.d, "float32", "relu")
        kernel += count * min(C.kernel_time(op, c) for c in tmpl.enumerate_configs(op))
        library += count * (C.cudnn_time(op) + C.elementwise_time(
            2 * op.d["oh"] * op.d["ow"] * op.d["cout"] * 4))
    log(f"[model at records] ResNet-18's 20 convs (f32, bias + relu), kernel at each "
        f"group's fastest modeled config / F.conv2d + relu: {1e3 * kernel:.4f} / "
        f"{1e3 * library:.4f} ms")
    log("[model at records] flash attention (H 16, D 128, bf16, default tile): " + "; ".join(
        f"{label} {1e3 * C.kernel_time(OpDesc.attention(b, sq, skv, 16, 128), {}):.4f} ms"
        for label, b, sq, skv in SERVE_ATTENTION))


def _graph_ops(graph, dtype):
    from repro_torch.core import op_desc_of

    ops, seen = [], set()
    for node in graph.toposort():
        op = op_desc_of(graph, node, dtype)
        if op is not None and op.signature() not in seen:
            seen.add(op.signature())
            ops.append(op)
    return ops


def phase_fitness(torch, served, counters, checks, torch_run, wall_plan, wall_tps,
                  wpk_plan):
    """The analytic fitness against the card (module docstring, phase 10).
    -> the kernels' launches on its paths."""
    from repro_torch.configs import get_config
    from repro_torch.core import (Engine, ModelFitness, Tuner, WallClockFitness,
                                  default_registry, optimize_graph, select)
    from repro_torch.models.resnet import resnet18_graph
    from repro_torch.serve.router import build_serve_graph, build_serve_plan

    def zero():
        for fn in counters:
            fn.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {fn.__name__: fn.launches for fn in counters if fn.launches}

    chk = {"matmul": checks[2], "conv2d": checks[3], "attention": checks[5]}
    gopt = optimize_graph(resnet18_graph(batch=1, image=WPK_IMAGE, seed=0))
    qcfg, scfg = get_config("qwen3-1.7b"), get_config("mamba2-2.7b")
    graphs = [("resnet18", _graph_ops(gopt, "float32")),
              ("qwen3-1.7b", _graph_ops(build_serve_graph(
                  qcfg, **SERVE_PLAN, dtype="bfloat16"), "bfloat16")),
              ("mamba2-2.7b", _graph_ops(build_serve_graph(
                  scfg, **SERVE_PLAN, dtype="bfloat16", family="ssm"), "bfloat16"))]
    zero()
    t0 = time.perf_counter()
    model = ModelFitness()
    for label, ops in graphs:
        fitness = WallClockFitness(device=DEVICE)
        log(f"[fitness {label}] per operator: every valid configuration measured "
            "(device time) and modeled")
        rows = [_fit_operator(torch, op, fitness, model, chk[op.kind]) for op in ops]
        _fit_summary(label, rows)
        del fitness
        free_device(torch)
    sweep = counts()
    log(f"[fitness] sweep: {time.perf_counter() - t0:.1f} s; launches {sweep}")
    _log_model_at_records()
    for name in ("matmul_fused", "conv2d_direct", "flash_attention"):
        if not sweep.get(name):
            raise AssertionError(f"{name} never launched in the fitness sweep")

    # ResNet-18 on a plan tuned on the host
    t0 = time.perf_counter()
    tuner = Tuner(fitness=ModelFitness())            # GA and RL, the agent on the CPU
    plan = select(gopt, tuner=tuner, dtype="float32")
    log(f"[fitness] ResNet-18 plan tuned on the model in {time.perf_counter() - t0:.2f} s "
        f"(PPO agent on {tuner.rl.device}): backends {plan.backend_histogram()} "
        f"(the device-time race plan: {wpk_plan.backend_histogram()})")
    x = torch.randn((1, 3, WPK_IMAGE, WPK_IMAGE),
                    generator=torch.Generator(device=DEVICE).manual_seed(6), device=DEVICE)
    engines = {"model-tuned plan, graphed": Engine(gopt, plan, default_registry(),
                                                  device=DEVICE),
               "device-time race plan, graphed": Engine(gopt, wpk_plan,
                                                        default_registry(), device=DEVICE)}
    for eng in engines.values():
        eng(x)                                       # warm-up, capture
    zero()
    engines["model-tuned plan, graphed"](x)
    forward = counts()
    err = engines["model-tuned plan, graphed"].verify_against_reference(
        x, rtol=WPK_TOL, atol=WPK_TOL)
    log(f"[fitness] model-tuned ResNet-18 plan: verify_against_reference max |err| "
        f"{err:.3e} (rtol = atol = {WPK_TOL:.0e}) ok; launches of a replayed forward "
        f"{forward}")
    for label, ms in _forward_ms(torch, engines, x).items():
        log(f"[fitness] [{label}] one forward: {ms:.4f} ms/image (median of "
            f"{FORWARD_REPEATS}, CUDA events, lanes in turn)")
    del engines

    # qwen3-1.7b served under a plan tuned on the host
    race, serving, mplan, mtps = race_and_serve(
        torch, served, counters, "qwen3 model-tuned", torch_run,
        tuner=Tuner(fitness=ModelFitness()))
    log(f"[fitness] qwen3 tokens/s graphed, this call: model-tuned plan {mtps:.1f}, "
        f"device-time plan (phase 5) {wall_tps:.1f}")

    # flips: the serve plan's race again on a fresh device-time fitness
    zero()
    t0 = time.perf_counter()
    again = build_serve_plan(qcfg, **SERVE_PLAN, dtype="bfloat16",
                             tuner=Tuner(fitness=WallClockFitness(device=DEVICE)))
    flip_race = counts()
    graph = build_serve_graph(qcfg, **SERVE_PLAN, dtype="bfloat16")
    names = [n.name for n in graph.toposort()]
    mm = [n for n in names if not n.endswith("attention")]
    flips = [n for n in mm if again.choices[n].backend != wall_plan.choices[n].backend]
    cfg_moves = [n for n in names if again.choices[n].backend == wall_plan.choices[n].backend
                 and again.choices[n].config != wall_plan.choices[n].config]
    log(f"[fitness] serve-plan race twice on device-time fitness (phase 5's and a fresh "
        f"one, {time.perf_counter() - t0:.1f} s): {len(flips)} of {len(mm)} matmul "
        f"nodes flip their winner {flips}; attention winners "
        f"{[(n, wall_plan.choices[n].backend, again.choices[n].backend) for n in names if n.endswith('attention')]}; "
        f"same winner, other config: {cfg_moves}")
    model_agree = sum(mplan.choices[n].backend == wall_plan.choices[n].backend for n in names)
    log(f"[fitness] the model-tuned serve plan picks phase 5's winner at "
        f"{model_agree} of {len(names)} nodes")
    return {"fitness_sweep": sweep, "fitness_resnet18_forward": forward,
            "fitness_serve_model_plan": serving, "fitness_flip_race": flip_race}


# -------------------------------------------------------------- phase 14
# Training qwen3-1.7b at full width and depth through the port's train
# step (`launch/steps.py::make_train_step`, the step `Trainer.run` calls):
# f32 master weights drawn on the card from seed 0, bf16 compute, full
# remat, AdamW.  Step 1's loss and gradient norm are held against an f32
# twin (the same config in f32, TF32 off, on the same parameters and
# batch).  bf16 rounds each product's inputs (2^-9 relative) and the
# embedding's gradient is accumulated in bf16 in both packages; over 28
# layers that moves the loss by ~1e-3 and the global norm by ~1 %:
# TRAIN_LOSS_ATOL / TRAIN_GNORM_RTOL leave 5-50x margin and still catch a
# wrong cast, a lost term or a dropped layer.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICROBATCHES = 1024, 8, 2
TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS = 2, 12
TRAIN_OPT = dict(lr=3e-4, warmup_steps=5, total_steps=40)
TRAIN_LOSS_ATOL, TRAIN_GNORM_RTOL = 0.05, 0.05
ADAMW_BYTES_PER_PARAM = 28      # read p, g, m, v; write p, m, v (f32)
ADAMW_REPEATS = 3
# `examples/train_lm.py`'s configuration, through `Trainer` (phase 15)
LOOP_STEPS, LOOP_PREEMPT_AT, LOOP_CKPT_EVERY = 200, 100, 25
LOOP_RESUME_ATOL = 1e-6         # tests/test_fault_tolerance.py's bound
# one train step of each other family at full width (depth cut as listed)
FAMILY_TRAIN = (("qwen2-moe-a2.7b", 2, 1024), ("mamba2-2.7b", 2, 1024),
                ("qwen2-vl-2b", 2, 1024), ("zamba2-1.2b", 6, 1024),
                ("whisper-base", None, 448))
FAMILY_TRAIN_BATCH = 2


def _matmul_params(params):
    """Parameters that enter a product (every dense weight and expert
    stack, the LM head included; not the embedding gather or the norms)."""
    from repro_torch.tree import tree_flatten_with_paths

    return sum(t.numel() for key, t in tree_flatten_with_paths(params)
               if key.split("/")[-1] in ("w", "w_in", "w_gate", "w_out"))


def _train_batch(torch, data, step, cfg, gen=None):
    """The pipeline's batch of `step` on the card, with the vlm's vision
    embeddings / whisper's audio frames drawn from `gen`."""
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(step).items()}
    b = batch["tokens"].shape[0]
    if cfg.family == "vlm":
        batch["vision_embeds"] = 0.02 * torch.randn(
            (b, cfg.n_vision_tokens, cfg.d_model), generator=gen, device=DEVICE)
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.randn((b, cfg.enc_seq, cfg.d_model),
                                            generator=gen, device=DEVICE)
    return batch


def _against_f32_twin(torch, label, model, params, batch, microbatches):
    """Loss and gradients of the bf16 model and of its f32 twin on the
    same parameters and batch: the loss within TRAIN_LOSS_ATOL, the global
    norm within TRAIN_GNORM_RTOL, every leaf's cosine logged.
    -> (bf16 loss, bf16 norm, peak GB)."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import build_model
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_flatten_with_paths

    twin = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss32, _, g32 = loss_and_grads(twin, params, batch, microbatches)
    loss16, _, g16 = loss_and_grads(model, params, batch, microbatches)
    n32, n16 = float(global_norm(g32)), float(global_norm(g16))
    loss32, loss16 = float(loss32), float(loss16)
    twin_s = time.perf_counter() - t0
    cosines = []
    g32 = dict(tree_flatten_with_paths(g32))
    for key, g in tree_flatten_with_paths(g16):
        a, b = g.double().flatten(), g32[key].double().flatten()
        den = float(a.norm() * b.norm())
        cosines.append((float(a @ b) / den if den > 0 else 1.0, key))
    del g16, g32
    peak = torch.cuda.max_memory_allocated() / 1e9
    cosines.sort()
    log(f"[{label}] step-1 loss bf16 {loss16:.6f} f32 {loss32:.6f} "
        f"(|d| {abs(loss16 - loss32):.2e}, tol {TRAIN_LOSS_ATOL}); grad norm bf16 "
        f"{n16:.6f} f32 {n32:.6f} (rel {abs(n16 / n32 - 1):.2e}, tol "
        f"{TRAIN_GNORM_RTOL}); {twin_s:.1f} s; peak with both gradients held "
        f"{peak:.2f} GB")
    log(f"[{label}] gradient cosine bf16 vs f32 per leaf: "
        + ", ".join(f"{k} {c:.5f}" for c, k in cosines))
    if not all(math.isfinite(x) for x in (loss16, loss32, n16, n32)):
        raise AssertionError(f"[{label}] non-finite loss or gradient norm")
    if abs(loss16 - loss32) > TRAIN_LOSS_ATOL or abs(n16 / n32 - 1) > TRAIN_GNORM_RTOL:
        raise AssertionError(f"[{label}] bf16 step 1 disagrees with its f32 twin")
    return loss16, n16, peak


def keep_leaf(torch, where, key, g):
    """Leave gradient leaf `key` on the host as `<where>/<key>.npy`, its
    bf16 rounding's bits (int16): phase 24 compares cosines, which the
    rounding (2^-9 relative) moves by ~1e-5, at half the bytes of f32."""
    import numpy as np

    path = os.path.join(where, key.replace("/", ".") + ".npy")
    np.save(path, g.to(torch.bfloat16).view(torch.int16).cpu().numpy())


def kept_leaf(torch, where, key):
    """`keep_leaf`'s leaf back, f32 on the card."""
    import numpy as np

    bits = np.load(os.path.join(where, key.replace("/", ".") + ".npy"))
    return torch.from_numpy(bits).view(torch.bfloat16).to(DEVICE).float()


def _profile_step(torch, label, fn):
    """One call of `fn` under torch.profiler: device events (kernels,
    copies, sets) and the device's busy share of its wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _log_device_profile(prof, wall, label, calls=1)
    if not rows:
        log(f"[{label}] profile: no device time in the trace (launches per step "
            "and busy share not measured)")
        return None
    events = sum(count for _, _, count in rows)
    log(f"[{label}] device events (kernels, copies, sets) per step: {events}")
    return events


def _dry_run_cross_check(torch, label, step_fn, state, batch, step_s, peak_gb, smi):
    """Phase 14's step lowered on the meta device with the dry run's meters
    (`launch/dryrun.py::Meters`: FlopCounterMode, CostCounter, MemTracker)
    beside one real step on the card under FlopCounterMode and
    CostCounter, in the dry run's order: the FLOPs, the bytes accessed and
    the transcendentals must each agree within 0.1 % (else the ops that
    differ are named and the phase fails); the meta argument bytes beside
    the bytes of the state and batch the card holds, MemTracker's peak
    beside `peak_gb`, MFU from the counted FLOPs at `step_s` beside 6 N T,
    and the counted roofline max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s)
    beside `step_s` (logged only)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.costcount import CostCounter
    from repro_torch.launch.dryrun import Meters, nbytes
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    meta = lambda t: torch.empty_like(t, device="meta")
    params = tree_map(meta, state["params"])
    opt = adamw_init(params)
    mbatch = {k: meta(v) for k, v in batch.items()}
    argument = nbytes(params) + nbytes(opt) + nbytes(mbatch)
    meters = Meters(params, opt)
    with meters():
        step_fn(params, opt, mbatch)
    rec = meters.record(argument)
    t_meta = time.perf_counter() - t0
    t0 = time.perf_counter()
    counter, cost = FlopCounterMode(display=False), CostCounter()
    with counter, cost:
        step_fn(state["params"], state["opt"], batch)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    meta_flops, card_flops = rec["cost"]["flops"], counter.get_total_flops()
    card_by_op = {str(op): int(n) for op, n in
                  counter.get_flop_counts().get("Global", {}).items()}
    meta_bytes, card_bytes = rec["cost"]["bytes accessed"], cost.total_bytes()
    meta_trans = rec["cost"]["transcendentals"]
    card_trans = cost.total_transcendentals()
    held = nbytes(state) + nbytes(batch)
    peak = rec["memory"]["peak_bytes_per_device"]
    n_mm = _matmul_params(state["params"])
    tokens = TRAIN_SEQ * TRAIN_BATCH
    log(f"[{label} dry run] {smi}: meta step {t_meta:.1f} s, card step under "
        f"FlopCounterMode and CostCounter {t_card:.1f} s; FLOPs meta {meta_flops:.6e} "
        f"{rec['flops_by_op']}, card {card_flops:.6e} {card_by_op}, ratio "
        f"{meta_flops / card_flops:.6f}")
    log(f"[{label} dry run] {smi}: argument bytes meta {argument:,}, the card's state + "
        f"batch {held:,}; MemTracker peak {peak / 1e9:.2f} GB "
        f"{rec['memory']['peak_by_category']}, measured peak {peak_gb:.2f} GB")
    log(f"[{label} dry run] {smi}: MFU from the counted FLOPs "
        f"{card_flops / step_s / BF16_FLOPS * 100:.2f} % ({card_flops:.4e} / "
        f"{step_s * 1e3:.1f} ms / 989 TFLOP/s), 6 N T {6 * n_mm * tokens / step_s / BF16_FLOPS * 100:.2f} %")
    log(f"[{label} dry run] {smi}: bytes accessed meta {meta_bytes:.6e}, card "
        f"{card_bytes:.6e}, ratio {meta_bytes / card_bytes:.6f}; transcendentals meta "
        f"{meta_trans:.6e}, card {card_trans:.6e}, ratio {meta_trans / card_trans:.6f}; "
        f"card bytes by op {cost.by_op(cost.bytes_by_op)}")
    t_flops, t_bytes = card_flops / BF16_FLOPS, card_bytes / HBM_BPS
    log(f"[{label} dry run] {smi}: counted roofline max({card_flops:.4e} FLOPs / 989 "
        f"TFLOP/s = {t_flops * 1e3:.1f} ms, {card_bytes:.4e} B / 3.35 TB/s = "
        f"{t_bytes * 1e3:.1f} ms) = {max(t_flops, t_bytes) * 1e3:.1f} ms "
        f"({'bytes' if t_bytes > t_flops else 'FLOPs'}), measured step "
        f"{step_s * 1e3:.1f} ms: {max(t_flops, t_bytes) / step_s * 100:.2f} % of it")
    pairs = {"FLOPs": (meta_flops, card_flops, rec["flops_by_op"], card_by_op),
             "bytes accessed": (meta_bytes, card_bytes, rec["bytes_by_op"],
                                dict(cost.bytes_by_op)),
             "transcendentals": (meta_trans, card_trans, rec["transcendentals_by_op"],
                                 dict(cost.transcendentals_by_op))}
    for what, (meta_n, card_n, meta_ops, card_ops) in pairs.items():
        if abs(meta_n / card_n - 1) > 1e-3:
            differ = {op: (meta_ops.get(op, 0), card_ops.get(op, 0))
                      for op in set(meta_ops) | set(card_ops)
                      if meta_ops.get(op, 0) != card_ops.get(op, 0)}
            raise AssertionError(f"[{label} dry run] meta and card {what} differ by more "
                                 f"than 0.1 %: (meta, card) by op {differ}")
    return {"meta_flops": meta_flops, "card_flops": card_flops, "meta_argument": argument,
            "card_held": held, "meta_peak": peak, "meta_bytes": meta_bytes,
            "card_bytes": card_bytes, "meta_transcendentals": meta_trans,
            "card_transcendentals": card_trans}


def phase_train(torch, cfg, counters, smi=""):
    """Phase 14 (see the module docstring); `smi`: the card's name and
    power limit, logged with the dry run's cross-check."""
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.launch.steps import TrainConfig, loss_and_grads, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_leaves

    label = "train qwen3"
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg, remat="full")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    state = {"params": params, "opt": adamw_init(params)}
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_mm = _matmul_params(params)
    log(f"[{label}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, remat {cfg.remat}; {n_params / 1e9:.4f} G parameters "
        f"({n_mm / 1e9:.4f} G in products), f32 masters + m + v "
        f"{3 * 4 * n_params / 1e9:.2f} GB, drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
    tcfg = TrainConfig(microbatches=TRAIN_MICROBATCHES, opt=AdamWConfig(**TRAIN_OPT))
    tokens = TRAIN_SEQ * TRAIN_BATCH

    _zeroed(counters)
    loss16, n16, twin_peak = _against_f32_twin(
        torch, label, model, params, _train_batch(torch, data, 0, cfg),
        TRAIN_MICROBATCHES)
    step_fn = make_train_step(model, tcfg, DEFAULT_RULES)
    losses, times = [], []
    for step in range(TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS):
        batch = _train_batch(torch, data, step, cfg)
        if step == TRAIN_WARMUP_STEPS:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state["params"], state["opt"], metrics = step_fn(state["params"],
                                                         state["opt"], batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        if step >= TRAIN_WARMUP_STEPS:
            times.append(dt)
        log(f"[{label}] step {step + 1:3d} loss {loss:.6f} grad_norm "
            f"{float(metrics['grad_norm']):.4f} lr {float(metrics['lr']):.3e} "
            f"{dt * 1e3:.1f} ms" + (" (warm-up)" if step < TRAIN_WARMUP_STEPS else ""))
        if step == 0:
            log(f"[{label}] step 1 through the train step: loss - twin check's "
                f"bf16 loss {loss - loss16:.3e}, grad norm - its norm "
                f"{float(metrics['grad_norm']) - n16:.3e}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    med = _median(times)
    log(f"[{label}] step ms over {len(times)} timed steps: median {med * 1e3:.1f} "
        f"(min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}); tokens/s "
        f"{tokens / med:.0f}; MFU {6 * n_mm * tokens / med / BF16_FLOPS * 100:.2f} % "
        f"(6 x {n_mm / 1e9:.4f} G product parameters x {tokens} tokens / step s / "
        f"989 TFLOP/s; attention's products and the remat recompute not counted); "
        f"peak device memory over the timed steps {peak:.2f} GB (with the f32 twin's "
        f"gradients: {twin_peak:.2f} GB)")

    # the AdamW update alone, on real gradients, by CUDA events
    _, _, grads = loss_and_grads(model, state["params"],
                                 _train_batch(torch, data, len(losses), cfg),
                                 TRAIN_MICROBATCHES)
    ms = []
    for _ in range(ADAMW_REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        adamw_update(state["params"], grads, state["opt"], tcfg.opt)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    bound_ms = ADAMW_BYTES_PER_PARAM * n_params / HBM_BPS * 1e3
    log(f"[{label}] AdamW update (CUDA events): {', '.join(f'{m:.2f}' for m in ms)} ms; "
        f"bytes bound {bound_ms:.2f} ms ({ADAMW_BYTES_PER_PARAM} B x "
        f"{n_params / 1e9:.4f} G / 3.35 TB/s): {_median(ms) / bound_ms:.2f}x")
    del grads
    _profile_step(torch, f"{label} profile", lambda: step_fn(
        state["params"], state["opt"], _train_batch(torch, data, len(losses), cfg)))
    _dry_run_cross_check(torch, label, step_fn, state,
                         _train_batch(torch, data, len(losses), cfg), med, peak, smi)

    first, last = losses[0], sum(losses[-5:]) / 5
    log(f"[{label}] loss: first {first:.6f}, mean of the last 5 {last:.6f}")
    if not all(math.isfinite(x) for x in losses) or not last < first:
        raise AssertionError(f"[{label}] the loss did not fall: {losses}")
    if _launched(counters):
        raise AssertionError(f"[{label}] hand-written kernels launched: "
                             f"{_launched(counters)}")
    log(f"[{label}] hand-written kernels launched: none")
    _phase_end(label, t_phase)


def _loop_trainer(ckpt_dir, mesh=None, steps=LOOP_STEPS):
    """`examples/train_lm.py`'s Trainer (phase 15), `steps` long, with no
    mesh or on `mesh` (the reference's guarded rules for it)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.launch.steps import TrainConfig, rules_for_shape
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config("qwen3-1.7b").reduced(n_layers=4, d_model=256, d_ff=1024, n_heads=4,
                                           n_kv_heads=2, head_dim=64, vocab=4096)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8))
    rules = DEFAULT_RULES if mesh is None else rules_for_shape(
        cfg, ShapeSpec("train", "train", 128, 8), mesh)
    return Trainer(build_model(cfg), mesh, rules, data, TrainerConfig(
        steps=steps, ckpt_every=LOOP_CKPT_EVERY, ckpt_dir=ckpt_dir, log_every=50,
        train=TrainConfig(microbatches=2, opt=AdamWConfig(lr=1e-3, warmup_steps=20,
                                                          total_steps=LOOP_STEPS))),
        device=DEVICE if mesh is None else None)


def _state_diff(torch, a, b):
    """{leaf: max |a - b|} over the leaves that differ."""
    from repro_torch.tree import tree_flatten_with_paths

    fb = dict(tree_flatten_with_paths(b))
    return {k: float((t.double() - fb[k].double()).abs().max())
            for k, t in tree_flatten_with_paths(a) if not torch.equal(t, fb[k])}


def phase_train_loop(torch, counters):
    """Phase 15 (see the module docstring)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.launch.steps import TrainConfig, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    label = "train loop"
    t_phase = time.perf_counter()
    _zeroed(counters)
    with tempfile.TemporaryDirectory() as tmp:
        full = _loop_trainer(os.path.join(tmp, "full"))
        t0 = time.perf_counter()
        step, s_full, info = full.run()
        wall = time.perf_counter() - t0
        if step != LOOP_STEPS or info["preempted"]:
            raise AssertionError(f"[{label}] uninterrupted run ended at {step}: {info}")
        losses = [r["loss"] for r in full.metrics_log]
        med = _median(full.step_times)
        log(f"[{label}] {LOOP_STEPS} steps in {wall:.1f} s: median step "
            f"{med * 1e3:.2f} ms ({8 * 128 / med:.0f} tokens/s), stragglers "
            f"{info['stragglers']}; loss {losses[0]:.4f} -> mean of the last 10 "
            f"{sum(losses[-10:]) / 10:.4f}")
        if not sum(losses[-10:]) / 10 < losses[0]:
            raise AssertionError(f"[{label}] the loss did not fall")
        restored = full.ckpt.restore(LOOP_STEPS, full.state_template(), full.device)
        if _state_diff(torch, restored, s_full):
            raise AssertionError(f"[{label}] checkpoint {LOOP_STEPS} differs from the "
                                 f"state: {_state_diff(torch, restored, s_full)}")
        log(f"[{label}] checkpoint of step {LOOP_STEPS} restores leaf for leaf, bitwise")

        part = _loop_trainer(os.path.join(tmp, "resumed"))

        def preempt(step, row):
            if step == LOOP_PREEMPT_AT:
                open(part.preempt_file, "w").close()

        step, _, info = part.run(on_step=preempt)
        if not info["preempted"] or step != LOOP_PREEMPT_AT or \
                not part.ckpt.meta(step).get("preempted"):
            raise AssertionError(f"[{label}] preemption: step {step}, {info}")
        os.remove(part.preempt_file)
        again = _loop_trainer(os.path.join(tmp, "resumed"))
        start, state = again.restore_or_init()
        if start != LOOP_PREEMPT_AT:
            raise AssertionError(f"[{label}] resumed at {start}")
        step, s_res, _ = again.run(start_step=start, state=state)
        diff = _state_diff(torch, s_res, s_full)
        worst = max(diff.values(), default=0.0)
        log(f"[{label}] preempted at {LOOP_PREEMPT_AT}, resumed by a fresh Trainer to "
            f"{step}: " + ("bitwise equal to the uninterrupted run" if not diff else
                           f"{len(diff)} leaves differ, max |d| {worst:.3e}: {diff}"))
        if step != LOOP_STEPS or worst > LOOP_RESUME_ATOL:
            raise AssertionError(f"[{label}] resumed run differs from the "
                                 f"uninterrupted one beyond {LOOP_RESUME_ATOL}")
    del full, part, again, s_full, s_res, state, restored
    free_device(torch)

    peaks = {}
    for arch, layers, seq in FAMILY_TRAIN:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        flabel = f"train {arch}"
        model = build_model(cfg)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        params = model.init(gen)
        data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                          global_batch=FAMILY_TRAIN_BATCH))
        batch = _train_batch(torch, data, 0, cfg, gen)
        log(f"[{flabel}] {cfg.n_layers} layers"
            f"{f' + {cfg.n_enc_layers} encoder layers' if cfg.n_enc_layers else ''}, "
            f"d_model {cfg.d_model}, vocab {cfg.vocab}; "
            f"{sum(t.numel() for t in _leaves(params)) / 1e9:.4f} G parameters; batch "
            + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items()))
        loss16, n16, twin_peak = _against_f32_twin(torch, flabel, model, params, batch, 1)
        state = {"params": params, "opt": adamw_init(params)}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state["params"], state["opt"], metrics = make_train_step(
            model, TrainConfig(), DEFAULT_RULES)(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        finite = all(bool(torch.isfinite(t).all()) for t in _leaves(state["params"]))
        peaks[arch] = max(twin_peak, torch.cuda.max_memory_allocated() / 1e9)
        log(f"[{flabel}] one train step: loss {loss:.6f} grad_norm "
            f"{float(metrics['grad_norm']):.4f} in {dt:.2f} s; parameters finite "
            f"{finite}; peak device memory {peaks[arch]:.2f} GB")
        if not (math.isfinite(loss) and finite):
            raise AssertionError(f"[{flabel}] non-finite step")
        del model, params, state, batch, metrics
        free_device(torch)
    if _launched(counters):
        raise AssertionError(f"[{label}] hand-written kernels launched: "
                             f"{_launched(counters)}")
    log(f"[{label}] hand-written kernels launched: none")
    _phase_end(label, t_phase)
    return peaks


# ------------------------------------------------------------ phases 16-19
# Phase 16, long-KV attention on the dense path (`models/attention.py`):
# the reference's `_sdpa` runs an online softmax over KV chunks from 1024
# keys on (`_sdpa_chunked`), which the port follows.  Attention alone at
# qwen3-1.7b's heads in both forms, forward and backward; a train step at
# 4096 tokens; one 32,768-token prompt through the fixed-batch prefill,
# whose direct form would hold 68.7 GB of logits a layer, against the
# continuous engine's kernel lanes on the same prompt.
LONG_ATTN = dict(b=4, s=4096, h=16, hkv=8, d=128)
LONG_ATTN_TOL = 2e-2            # x max |.|: two bf16 forms (the chunked one
                                # rounds each chunk's P·V product to bf16)
LONG_TRAIN_SEQ, LONG_TRAIN_BATCH, LONG_TRAIN_MICRO = 4096, 8, 2
LONG_TRAIN_WARMUP, LONG_TRAIN_TIMED = 1, 1  # its steps' times spread < 1 %
LONG_PROMPT = 32_768


def _count_chunked():
    """Wrap `models.attention._sdpa_chunked` with a call counter: -> (the
    counter list, a function that restores the original)."""
    from repro_torch.models import attention as A

    calls, orig = [], A._sdpa_chunked

    def spy(*a, **kw):
        calls.append(kw.get("kv_chunk"))
        return orig(*a, **kw)

    A._sdpa_chunked = spy
    return calls, lambda: setattr(A, "_sdpa_chunked", orig)


def _long_attention_forms(torch):
    """Attention alone at qwen3-1.7b's heads (B 4, S 4096, 16 / 8 heads x
    128, causal, bf16), forward and backward of a seeded cotangent, once in
    the direct form and once in the chunked form (4 chunks of 1024): each
    one's device ms (CUDA events, the second of two calls) and peak memory
    above its inputs; outputs and gradients must agree at LONG_ATTN_TOL x
    max, and each is logged against the f32 direct form."""
    from repro_torch.models import attention as A

    b, s, h, hkv, d = (LONG_ATTN[k] for k in ("b", "s", "h", "hkv", "d"))
    g = torch.Generator(device=DEVICE).manual_seed(21)
    q = torch.randn((b, s, h, d), generator=g, device=DEVICE).to(torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=g, device=DEVICE).to(torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=g, device=DEVICE).to(torch.bfloat16)
    ct = torch.randn((b, s, h, d), generator=g, device=DEVICE)
    chunk = A._kv_chunk_for(s)
    forms = {"direct": A._sdpa_direct,
             "chunked": lambda *a: A._sdpa_chunked(*a, kv_chunk=chunk)}
    if chunk != 1024:
        raise AssertionError(f"S={s}: chunk {chunk}, want 1024")
    results = {}
    for name, form in forms.items():
        for rep in range(2):
            qq, kk, vv = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = form(qq, kk, vv, True, h // hkv)
            (out.float() * ct).sum().backward()
            end.record()
            end.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ms = start.elapsed_time(end)
        results[name] = (out.detach(), (qq.grad, kk.grad, vv.grad), ms, peak)
        del out, qq, kk, vv
    qf, kf, vf = (x.float().requires_grad_(True) for x in (q, k, v))
    outf = A._sdpa_direct(qf, kf, vf, True, h // hkv)
    (outf * ct).sum().backward()
    exact = (outf.detach(), (qf.grad, kf.grad, vf.grad))

    def rel(a, w):
        return ((a.float() - w.float()).abs().max() / w.float().abs().max()).item()

    for name, (out, grads, ms, peak) in results.items():
        errs = [rel(out, exact[0])] + [rel(gr, w) for gr, w in zip(grads, exact[1])]
        log(f"[long attention] {name} form B={b} S={s} H={h} Hkv={hkv} D={d} causal "
            f"bf16, forward + backward: {ms:.3f} ms (CUDA events, second call); peak "
            f"{peak / 1e9:.3f} GB above the inputs; vs the f32 direct form: out "
            f"{errs[0]:.2e}, dq {errs[1]:.2e}, dk {errs[2]:.2e}, dv {errs[3]:.2e} x max")
    d_out, d_grads = results["direct"][:2]
    c_out, c_grads = results["chunked"][:2]
    errs = [rel(c_out, d_out)] + [rel(a, w) for a, w in zip(c_grads, d_grads)]
    log(f"[long attention] chunked vs direct: out {errs[0]:.2e}, dq {errs[1]:.2e}, "
        f"dk {errs[2]:.2e}, dv {errs[3]:.2e} x max (tolerance {LONG_ATTN_TOL}); "
        f"peak {results['direct'][3] / results['chunked'][3]:.2f}x less in the "
        f"chunked form, {results['chunked'][2] / results['direct'][2]:.2f}x the "
        "direct form's ms")
    if max(errs) > LONG_ATTN_TOL:
        raise AssertionError(f"long attention: the two forms disagree ({errs})")
    return {name: (r[2], r[3]) for name, r in results.items()}


def _long_train(torch, counters):
    """qwen3-1.7b trained at seq 4096 x batch 8 (2 microbatches, remat
    full, phase 14's optimiser) for LONG_TRAIN_WARMUP warm-up and
    LONG_TRAIN_TIMED timed steps: step ms,
    tokens/s, peak memory, the chunked form's calls a step; the loss must
    be finite and no hand-written kernel may launch."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.launch.steps import TrainConfig, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    label = "long train"
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), remat="full")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    state = {"params": params, "opt": adamw_init(params)}
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=LONG_TRAIN_SEQ,
                                      global_batch=LONG_TRAIN_BATCH))
    step_fn = make_train_step(model, TrainConfig(microbatches=LONG_TRAIN_MICRO,
                                                 opt=AdamWConfig(**TRAIN_OPT)),
                              DEFAULT_RULES)
    tokens = LONG_TRAIN_SEQ * LONG_TRAIN_BATCH
    _zeroed(counters)
    calls, restore = _count_chunked()
    losses, times = [], []
    try:
        for step in range(LONG_TRAIN_WARMUP + LONG_TRAIN_TIMED):
            batch = _train_batch(torch, data, step, cfg)
            if step == LONG_TRAIN_WARMUP:
                torch.cuda.reset_peak_memory_stats()
                calls.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state["params"], state["opt"], metrics = step_fn(state["params"],
                                                             state["opt"], batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            if step >= LONG_TRAIN_WARMUP:
                times.append(dt)
            log(f"[{label}] step {step + 1} loss {loss:.6f} grad_norm "
                f"{float(metrics['grad_norm']):.4f} {dt * 1e3:.1f} ms"
                + (" (warm-up)" if step < LONG_TRAIN_WARMUP else ""))
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated() / 1e9
    med = _median(times)
    per_step = len(calls) // LONG_TRAIN_TIMED
    log(f"[{label}] qwen3-1.7b seq {LONG_TRAIN_SEQ} x batch {LONG_TRAIN_BATCH}, "
        f"{LONG_TRAIN_MICRO} microbatches, remat full: step ms median "
        f"{med * 1e3:.1f} (min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}) "
        f"over {len(times)} steps; tokens/s {tokens / med:.0f}; peak device memory "
        f"over the timed steps {peak:.2f} GB; the chunked form ran {per_step} times a "
        f"step ({cfg.n_layers} layers x {LONG_TRAIN_MICRO} microbatches x forward "
        "and recompute), chunks of "
        f"{sorted(set(calls))}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[{label}] non-finite loss: {losses}")
    if per_step <= 0:
        raise AssertionError(f"[{label}] the chunked form never ran")
    if _launched(counters):
        raise AssertionError(f"[{label}] hand-written kernels launched: "
                             f"{_launched(counters)}")
    return {"step_ms": med * 1e3, "tokens_s": tokens / med, "peak_gb": peak}


def _long_prefill(torch):
    """One 32,768-token prompt (seeded) on qwen3-1.7b (bf16, `init_serving`
    from seed 0): the fixed-batch `prefill_step` with no autograd graph
    (peak memory above the parameters, seconds, the chunked form's calls),
    then the same prompt through a one-slot `ContinuousEngine` on the
    graphed kernel lanes, block tables of (32,768 + 32) / 16 blocks.  The
    two first tokens must agree where the prefill's top-2 margin exceeds
    FIRST_TOKEN_MARGIN; the four serving kernels must each launch in the
    engine run.  -> (the engine run's launches, the prefill's seconds and
    peak GB)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig

    label = "32k prefill"
    cfg = get_config("qwen3-1.7b")
    model, params = family_setup(torch, cfg)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, size=LONG_PROMPT
                                               ).astype(np.int32)
    n_new = SERVE_RUNTIME["max_new_tokens"]
    max_seq = LONG_PROMPT + n_new
    tokens = torch.as_tensor(prompt[None], device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    calls, restore = _count_chunked()
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = steps.prefill_step(model, params, tokens, max_seq)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        restore()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    cache_gb = sum(t.numel() * t.element_size() for t in cache.values()) / 1e9
    fixed = logits[0, -1].to("cpu", torch.float32)
    del logits, cache
    top2 = torch.topk(fixed, 2)
    margin = float(top2.values[0] - top2.values[1])
    log(f"[{label}] fixed-batch prefill_step of one {LONG_PROMPT}-token prompt "
        f"(max_seq {max_seq}): {secs:.3f} s, peak {peak:.2f} GB above the "
        f"parameters (the dense cache {cache_gb:.2f} GB of it; the direct form's "
        f"logits alone would be {16 * LONG_PROMPT ** 2 * 4 / 1e9:.1f} GB a layer); "
        f"chunked form {len(calls)} calls, chunks {sorted(set(calls))}")
    if len(calls) != cfg.n_layers or not bool(torch.isfinite(fixed).all()):
        raise AssertionError(f"[{label}] {len(calls)} chunked calls or non-finite logits")

    gc.collect()
    blocks = -(-max_seq // SERVE_RUNTIME["block_size"])
    rcfg = RuntimeConfig(**{**SERVE_RUNTIME, "max_slots": 1,
                            "max_blocks_per_seq": blocks})
    eng = ContinuousEngine(model, params, rcfg, router=kernel_lane_router(PREFILL_BLOCK_Q),
                           device=DEVICE)
    firsts = _spy_first_logits(eng)
    serving = _serve_counters()
    _zeroed(serving)
    eng.submit(prompt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in serving}
    s = eng.metrics.summary()
    out = done[0].output
    engine_first = firsts[done[0].rid]
    log(f"[{label}] ContinuousEngine, kernel lanes graphed, 1 slot, tables of "
        f"{blocks} blocks: {wall:.3f} s for {len(out)} tokens, TTFT "
        f"{s['ttft_p50_s']:.3f} s, {int(s['chunk_steps'])} unified and "
        f"{int(s['decode_only_steps'])} decode-only steps; launches {launches}")
    log(f"[{label}] first token: fixed-batch {int(top2.indices[0])} (top-2 margin "
        f"{margin:.3f}), engine {out[0]}; max |logit difference| "
        f"{(engine_first - fixed).abs().max().item():.4f}")
    if len(out) != n_new or not all(0 <= t < cfg.vocab for t in out):
        raise AssertionError(f"[{label}] bad engine stream")
    if margin > FIRST_TOKEN_MARGIN and out[0] != int(top2.indices[0]):
        raise AssertionError(f"[{label}] first tokens differ at margin {margin:.3f}")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"[{label}] {missing} never launched")
    del eng
    return launches, secs, peak


def phase_long_kv(torch, counters):
    """Phase 16 (see the module docstring and the comment above).  -> the
    kernels' launches on the 32k engine run's path."""
    t_phase = time.perf_counter()
    _long_attention_forms(torch)
    free_device(torch)
    _long_train(torch, counters)
    free_device(torch)
    launches, _, _ = _long_prefill(torch)
    _phase_end("long kv", t_phase)
    return {"prefill_32k_qwen3_engine": launches}


def phase_mesh(torch):
    """Phase 19: `launch/mesh.py::single_device_mesh()` on the card in this
    process, which holds no process group (it starts a world of one on
    nccl), then qwen3-1.7b's parameter shardings under
    `rules_for_shape(cfg, SHAPES["decode_32k"], mesh)`: every leaf must be
    replicated on the (1, 1) mesh; one leaf distributed as a DTensor must
    hold the tensor bitwise.  The group is destroyed after."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import params_shardings, prune_for_mesh
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.steps import rules_for_shape
    from repro_torch.models import build_model
    from repro_torch.tree import tree_flatten_with_paths

    t_phase = time.perf_counter()
    if dist.is_initialized():
        raise AssertionError("[mesh] a process group is already up")
    mesh = single_device_mesh()
    try:
        cfg = get_config("qwen3-1.7b")
        rules = prune_for_mesh(rules_for_shape(cfg, SHAPES["decode_32k"], mesh), mesh)
        shard = list(tree_flatten_with_paths(
            params_shardings(mesh, rules, build_model(cfg).logical_axes())))
        odd = [k for k, sh in shard if any(p != Replicate() for p in sh.placements)]
        log(f"[mesh] {mesh} on backend {dist.get_backend()} (world "
            f"{dist.get_world_size()}); qwen3-1.7b under decode_32k's rules: "
            f"{len(shard)} leaves, {len(shard) - len(odd)} with Replicate() on every "
            f"mesh dim; specs e.g. {shard[0][0]} {tuple(shard[0][1].spec)}")
        if odd or not shard:
            raise AssertionError(f"[mesh] leaves not replicated: {odd}")
        x = torch.randn((64, 128), device=DEVICE)
        dx = shard[0][1].distribute(x)
        if not torch.equal(dx.to_local(), x) or dx.to_local().device.type != "cuda":
            raise AssertionError("[mesh] a distributed leaf differs from its tensor")
    finally:
        dist.destroy_process_group()
    log(f"[mesh] phase seconds: {time.perf_counter() - t_phase:.1f}")


# ------------------------------------------------------------ phase 20
# The layout race on the card: qwen3-1.7b's serve plan at full width tuned
# with model_parallel = 2, 4, 8 on one device-time tuner (random search,
# 4 configurations a template: the replicated race is the same at every
# width and comes from the tuner's cache after the first).
TP_RACE_WIDTHS = (2, 4, 8)
TP_RACE_BUDGET = 4


def phase_layout_race(torch, counters):
    """Phase 20.  Each tuned plan must carry both layouts' times on every
    serving node whose shard dim divides (`core.costmodel.sharded_op_desc`)
    and none on any other, its verdict the faster (ties replicated); it
    must survive `save` / `load` unchanged; `serve_rules` of each plan and
    of no plan are logged.  -> the race's launches."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core import costmodel
    from repro_torch.core.plan import InferencePlan
    from repro_torch.core.search.tuner import Tuner
    from repro_torch.core.selection import op_desc_of
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.serve.router import PlanRouter, build_serve_graph, build_serve_plan

    t_phase = time.perf_counter()
    for fn in counters:
        fn.launches = 0
    cfg = get_config("qwen3-1.7b")
    graph = build_serve_graph(cfg, **SERVE_PLAN, dtype="bfloat16")
    tuner = Tuner(methods=("random",), random_budget=TP_RACE_BUDGET)
    axes = ("heads", "kv_heads", "ffn", "vocab", "embed_vec")
    tmp = tempfile.mkdtemp(prefix="layout_race_")
    for tp in TP_RACE_WIDTHS:
        r = PlanRouter(None).serve_rules(DEFAULT_RULES, _AxisSizes(tp), cfg)
        log(f"[layout race] tp={tp} serve_rules with no plan: "
            f"{ {a: r.lookup(a) for a in axes} }")
    for tp in TP_RACE_WIDTHS:
        t0 = time.perf_counter()
        plan = build_serve_plan(cfg, **SERVE_PLAN, tuner=tuner, model_parallel=tp)
        path = os.path.join(tmp, f"plan_tp{tp}.json")
        plan.save(path)
        loaded = InferencePlan.load(path)
        if loaded.to_json() != plan.to_json():
            raise AssertionError(f"[layout race] tp={tp}: the plan changed through save / load")
        log(f"[layout race] tp={tp}: {len(plan.choices)} nodes raced in "
            f"{time.perf_counter() - t0:.1f} s (device time); per node: replicated ms, "
            f"model-parallel ms (shard shape + collective), verdict, backend")
        for node in graph.toposort():
            op = op_desc_of(graph, node, "bfloat16")
            role = node.name.rsplit(".", 1)[-1]
            c = loaded.choices[node.name]
            lc = c.layout_candidates
            shard = costmodel.sharded_op_desc(op, role, tp)
            if shard is None:
                if lc or c.layout != "replicated":
                    raise AssertionError(f"[layout race] {node.name} tp={tp}: an "
                                         f"indivisible shard dim raced {lc}")
                log(f"  {node.name:24s} not raced (shard dim does not divide {tp})")
                continue
            if set(lc) != {"replicated", "model_parallel"}:
                raise AssertionError(f"[layout race] {node.name} tp={tp}: candidates {lc}")
            want = ("model_parallel" if lc["model_parallel"] < lc["replicated"]
                    else "replicated")
            if c.layout != want or c.modeled_time_s != lc[c.layout]:
                raise AssertionError(f"[layout race] {node.name} tp={tp}: verdict "
                                     f"{c.layout} at {c.modeled_time_s} against {lc}")
            coll = costmodel.layout_collective_time(op, role, tp)
            log(f"  {node.name:24s} {1e3 * lc['replicated']:.4f} "
                f"{1e3 * lc['model_parallel']:.4f} (collective {1e3 * coll:.4f}) "
                f"{c.layout:14s} {c.backend}")
        router = PlanRouter(loaded)
        r = router.serve_rules(DEFAULT_RULES, _AxisSizes(tp), cfg)
        log(f"[layout race] tp={tp} layout table (decode) {router.layout_table('decode')}; "
            f"(prefill_chunk) {router.layout_table('prefill_chunk')}; serve_rules "
            f"{ {a: r.lookup(a) for a in axes} }")
    _phase_end("layout race", t_phase)
    return {"layout_race_qwen3": {fn.__name__: fn.launches for fn in counters}}


# ------------------------------------------------------------ phase 21
# Tensor-parallel serving.  (a) qwen3-1.7b's kernel lanes on tp_mesh(1)
# (a world of one on nccl in this process), graphed, against the engine
# with no mesh: bitwise.  (b) tp = 2 and 4 as 2 and 4 processes sharing
# the card (cuda:0), each width a gloo world over a FileStore and the two
# worlds side by side (`_tp_worlds`), each rank serving
# the first TP_PROMPTS prompts on its shards, eagerly, every collective
# staged through the host (gloo): streams equal on every rank, held
# against the dense torch path (`stream_check`), one signature per
# program, launches and peak memory per rank.  One card shares its SMs
# among the ranks and gloo moves every partial through host memory, so
# the tokens/s logged measure no tensor-parallel speed.
TP_SERVE_WIDTHS = (2, 4)
TP_PROMPTS = 8
TP_SERVE_LAYERS = 8            # the ranks' depth (28 in the published config)
TP_CHILD_TIMEOUT_S = 600


def tp_child(torch, rank, world, store, out_path):
    """One rank of phase 21 (b), run as `chip_smoke.py --tp-child RANK
    WORLD STORE OUT`: qwen3-1.7b at TP_SERVE_LAYERS layers drawn from seed 0
    on the card, served on
    its shards of `tp_mesh(world)`; writes its streams, program counts,
    launches, memory and times to OUT as JSON."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.launch.mesh import init_file_world, tp_mesh
    from repro_torch.models import build_model
    from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig

    torch.cuda.set_device(0)
    torch.cuda.init()
    init_file_world(store, rank, world, "gloo")
    try:
        mesh = tp_mesh(world)
        cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=TP_SERVE_LAYERS)
        model = build_model(cfg)
        params = model.init_serving(torch.Generator(device=DEVICE).manual_seed(0))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
                   for n in PROMPT_LENS][:TP_PROMPTS]
        eng = ContinuousEngine(model, params, RuntimeConfig(**SERVE_RUNTIME),
                               router=kernel_lane_router(PREFILL_BLOCK_Q), device=DEVICE,
                               mesh=mesh, rules=DEFAULT_RULES)
        del params                      # the engine holds the rank's shards
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        progs = (eng._unified, eng._decode_only)
        for p in prompts:
            eng.submit(p)
        admission = [p._cache_size() for p in progs]
        counters = _serve_counters()
        for fn in counters:
            fn.launches = 0
        dist.barrier()
        done = eng.run()
        torch.cuda.synchronize()
        s = eng.metrics.summary()
        eng.cache.alloc.check_invariants()
        result = {
            "rank": rank, "world": world, "mesh": eng.mesh_tag,
            "rules": {a: eng.rules.lookup(a) for a in
                      ("heads", "kv_heads", "ffn", "vocab", "embed_vec")},
            "kv_heads": list(model.tp_kv_heads(eng.tp)),
            "streams": {str(r.rid): [int(t) for t in r.output] for r in done},
            "admission": admission, "sizes": [p._cache_size() for p in progs],
            "captures": sum(p.captures for p in progs),
            "launches": {fn.__name__: fn.launches for fn in counters},
            "param_gb": sum(t.numel() * t.element_size() for t in _leaves(eng.params)) / 1e9,
            "pool_gb": 2 * eng.cache.k.numel() * eng.cache.k.element_size() / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "tokens_per_s": s["tokens_per_s"], "wall_s": s["wall_s"],
            "steps": int(s["chunk_steps"] + s["decode_only_steps"]),
            "drained": eng.cache.alloc.num_used == 0,
        }
        with open(out_path, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def _tp_worlds(widths, tmp, flag="--tp-child", tag="", extra=(), env=None):
    """Run phase 21 (b)'s ranks of every width in `widths` side by side
    (with `flag` "--tp-family-child": phase 22's, and so on; `extra`: more
    arguments), each width a world of its own over its own store, as
    processes on the card; -> {width: each rank's result}.  Any rank that
    fails or outlives TP_CHILD_TIMEOUT_S fails the phase (the others are
    killed first)."""
    procs = []
    for tp in widths:
        store = os.path.join(tmp, f"store{tag}{tp}")
        for r in range(tp):
            out, logf = (os.path.join(tmp, f"tp{tag}{tp}.{r}{ext}") for ext in (".json", ".log"))
            with open(logf, "w") as f:
                procs.append((tp, r, out, logf, subprocess.Popen(
                    [sys.executable, os.path.join(ROOT, "chip_smoke.py"), flag,
                     str(r), str(tp), store, out, *extra], stdout=f,
                    stderr=subprocess.STDOUT, env=env, cwd=ROOT)))
    failed = []
    deadline = time.perf_counter() + TP_CHILD_TIMEOUT_S
    try:
        for tp, r, _, logf, p in procs:
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                with open(logf) as f:
                    failed.append(f"tp={tp} rank {r}: {rc}\n{f.read()[-4000:]}")
    finally:
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError("ranks failed:\n" + "\n".join(failed))
    results = {tp: [] for tp in widths}
    for tp, _, out, _, _ in procs:
        with open(out) as f:
            results[tp].append(json.load(f))
    return results


def _tp_world(tp, tmp, flag="--tp-child", tag="", extra=(), env=None):
    """`_tp_worlds` of one width: -> each rank's result."""
    return _tp_worlds((tp,), tmp, flag, tag, extra, env)[tp]


def phase_tp_serving(torch, counters):
    """Phase 21 (see the comment above).  -> launches per path: the
    tp_mesh(1) run's and each rank's."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import tp_mesh

    t_phase = time.perf_counter()
    served = serving_setup(torch, get_config("qwen3-1.7b"))
    model, params, prompts = served
    router = kernel_lane_router(PREFILL_BLOCK_Q)

    def run(label, **kw):
        for fn in counters:
            fn.launches = 0
        out, first, s = serve(torch, served, router, label, **kw)
        return out, first, s, {fn.__name__: fn.launches for fn in counters}

    base = run("qwen3 no mesh, graphed")
    if dist.is_initialized():
        raise AssertionError("[tp] a process group is already up")
    mesh = tp_mesh(1)
    try:
        one = run("qwen3 tp_mesh(1), graphed", mesh=mesh, rules=DEFAULT_RULES)
        # the ranks' depth: the reference their launches and streams meet
        del served, model, params
        free_device(torch)
        served = serving_setup(torch, dataclasses.replace(get_config("qwen3-1.7b"),
                                                          n_layers=TP_SERVE_LAYERS))
        model, params, prompts = served
        eager = run(f"qwen3 tp_mesh(1), eager, {TP_SERVE_LAYERS} layers", mesh=mesh,
                    rules=DEFAULT_RULES, graphs=False, prompts=prompts[:TP_PROMPTS],
                    check_schedule=False)
    finally:
        dist.destroy_process_group()
    if one[0] != base[0] or not _same_firsts(one[1], base[1]) or one[3] != base[3]:
        raise AssertionError(
            f"[tp] tp_mesh(1) differs from no mesh: streams {one[0] == base[0]}, "
            f"launches {one[3]} vs {base[3]}, first divergence "
            f"{_first_divergence(base[0], one[0])}")
    log(f"[tp] tp_mesh(1) (mesh {mesh.shape}) = no mesh: streams, first-token logits "
        f"(bitwise) and launches {one[3]}; tokens/s {one[2]['tokens_per_s']:.1f} vs "
        f"{base[2]['tokens_per_s']:.1f}")
    paths = {"serve_qwen3_tp_mesh1": one[3]}
    ref = eager[0]
    checked = {}                               # rid -> streams already checked

    build.build_all()                          # every library in place before spawning
    tmp = tempfile.mkdtemp(prefix="tp_worlds_")
    t0 = time.perf_counter()
    worlds = _tp_worlds(TP_SERVE_WIDTHS, tmp)  # the widths side by side
    wall = time.perf_counter() - t0
    for tp, ranks in worlds.items():
        for res in ranks[1:]:
            if res["streams"] != ranks[0]["streams"]:
                raise AssertionError(f"[tp={tp}] rank {res['rank']}'s streams differ "
                                     "from rank 0's")
        for res in ranks:
            log(f"[tp={tp}] rank {res['rank']} ({res['mesh']}, rules {res['rules']}, KV "
                f"heads {res['kv_heads']}): {res['steps']} steps, "
                f"{res['tokens_per_s']:.1f} tokens/s in {res['wall_s']:.2f} s, "
                f"programs {res['sizes']} (at admission {res['admission']}, "
                f"captures {res['captures']}), launches {res['launches']}, params "
                f"{res['param_gb']:.3f} GB, pools {res['pool_gb']:.3f} GB, peak "
                f"{res['peak_gb']:.2f} GB")
            if (res["sizes"] != [1, 1] or res["admission"] != [0, 0]
                    or res["captures"] != 0 or not res["drained"]):
                raise AssertionError(f"[tp={tp}] rank {res['rank']}: programs "
                                     f"{res['sizes']}, admission {res['admission']}, "
                                     f"captures {res['captures']}")
            missing = [k for k, n in res["launches"].items() if n <= 0]
            if missing:
                raise AssertionError(f"[tp={tp}] rank {res['rank']}: {missing} never "
                                     "launched")
            # the same host logic on the same requests: the same steps at
            # the same shapes as the tp = 1 eager run, so the same launches
            want = {k: eager[3][k] for k in res["launches"]}
            if res["launches"] != want:
                raise AssertionError(f"[tp={tp}] rank {res['rank']}: launches "
                                     f"{res['launches']}, tp = 1 eager {want}")
            paths[f"serve_qwen3_tp{tp}_rank{res['rank']}"] = res["launches"]
        out = {int(k): v for k, v in ranks[0]["streams"].items()}
        if sorted(out) != sorted(ref) or any(len(v) != SERVE_RUNTIME["max_new_tokens"]
                                             for v in out.values()):
            raise AssertionError(f"[tp={tp}] requests {sorted(out)} unfinished")
        same = sum(out[r] == ref[r] for r in ref)
        log(f"[tp={tp}] {tp} ranks (beside the other widths' in {wall:.1f} s, start "
            f"included); streams equal on every rank; {same}/{len(ref)} identical to the "
            f"tp=1 eager run's, first divergence {_first_divergence(ref, out)}")
        todo = sorted(r for r in out if checked.get(r) != out[r])
        stream_check(torch, f"qwen3 tp={tp}", model, params,
                     [prompts[r - 1] for r in todo], {r: out[r] for r in todo})
        checked.update({r: out[r] for r in todo})
    _phase_end("tp serving", t_phase)
    return paths


# ------------------------------------------------------------ phase 22
# Tensor-parallel serving of the other ContinuousEngine families:
# qwen2-vl-2b, mamba2-2.7b and qwen2-moe-a2.7b at full width and the cut
# depth TP_FAMILY_CHILD_LAYERS (an earlier path, cut for the script's
# time) (random weights from seed 0), each on its kernel-lane plan and the first
# TP_PROMPTS prompts.  (a) In this process, for each model: no mesh and
# tp_mesh(1), graphed, bitwise equal (streams, first-token logits,
# launches), then tp_mesh(1) eagerly, the run the ranks are held to.
# (b) tp = 2 and 4 as gloo worlds of processes sharing the card
# (`--tp-family-child`), each rank serving the three models in turn, each
# drawn straight into the rank's shards (`init_serving(..., tp=)` through
# the engine's params callable: the MoE's whole stacks never exist on a
# rank): streams equal on every rank, one signature per program, nothing
# captured, every request drained, launches of paged decode / prefill,
# the GEMM and the draw equal to the tp = 1 eager run's, and each rank's
# peak memory within its shards plus one full leaf of the model in f32
# (the dtype its init draws in) and that leaf's f32 shard (what
# `init_serving(tp=)` holds at once).  (c) Each width's streams replayed
# teacher-forced through the tp = 1 engine on the torch lanes
# (`forced_check`): every token whose top-2 margin there exceeds 0.25
# must be its argmax.  Logged, not gated: how many streams equal tp = 1's
# (cuBLAS may pick another algorithm for an E/tp-batch bmm), params,
# pools and peaks per rank, tokens/s (a gloo emulation on one card: no TP
# speed).
def _family_setup(torch, cfg):
    """(model, params, the first TP_PROMPTS prompts) of a phase-22 model."""
    model, params, prompts = (ssm_setup if cfg.family == "ssm" else serving_setup)(
        torch, cfg)
    return model, params, prompts[:TP_PROMPTS]


def family_router(cfg):
    """The model's kernel-lane plan: every role-tagged matmul on the GEMM,
    and a decoder's attention on the paged kernels."""
    return ssm_kernel_router() if cfg.family == "ssm" else kernel_lane_router(PREFILL_BLOCK_Q)


def full_leaf_bytes(cfg):
    """Bytes of the whole model's largest parameter leaf in f32: a stacked
    expert, projection or MLP leaf, or the embedding."""
    d, n = cfg.d_model, cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * d
        proj = 2 * d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim
        sizes = [n * d * proj, n * d_in * d]
        if cfg.family == "hybrid":          # the shared block: one, not stacked
            sizes += [d * cfg.d_ff, d * cfg.n_heads * cfg.hd]
    elif cfg.family == "moe":
        sizes = [n * cfg.n_experts * d * cfg.d_expert,
                 n * d * cfg.n_shared_experts * cfg.d_expert]
    else:
        sizes = [n * d * cfg.d_ff, n * d * cfg.n_heads * cfg.hd]
    return 4 * max(sizes + [cfg.vocab * d])


def tp_family_child(torch, rank, world, store, out_path):
    """One rank of phase 22 (b), run as `chip_smoke.py --tp-family-child
    RANK WORLD STORE OUT`: the three models in turn, each drawn from seed 0
    straight into the rank's shards and served on `tp_mesh(world)`; writes
    each model's streams, program counts, launches, memory and times to
    OUT as JSON."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.launch.mesh import init_file_world, tp_mesh
    from repro_torch.models import build_model
    from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig

    torch.cuda.set_device(0)
    torch.cuda.init()
    init_file_world(store, rank, world, "gloo")
    results = {}
    try:
        mesh = tp_mesh(world)
        for arch in TP_FAMILY_ARCHS:
            cfg = tp_family_cfg(arch)
            model = build_model(cfg)
            rng = np.random.default_rng(0)
            prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
                       for n in PROMPT_LENS][:TP_PROMPTS]
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device=DEVICE).manual_seed(0)
            t0 = time.perf_counter()
            eng = ContinuousEngine(model, lambda tp: model.init_serving(gen, tp=tp),
                                   RuntimeConfig(**SERVE_RUNTIME), router=family_router(cfg),
                                   device=DEVICE, mesh=mesh, rules=DEFAULT_RULES)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            init_peak = torch.cuda.max_memory_allocated()
            progs = (eng._unified, eng._decode_only)
            for p in prompts:
                eng.submit(p)
            admission = [p._cache_size() for p in progs]
            counters = _serve_counters()
            for fn in counters:
                fn.launches = 0
            dist.barrier()
            done = eng.run()
            torch.cuda.synchronize()
            s = eng.metrics.summary()
            eng.cache.alloc.check_invariants()
            pools = ((eng.cache.conv, eng.cache.ssm) if eng.family == "ssm"
                     else (eng.cache.k, eng.cache.v))
            results[arch] = {
                "rank": rank, "world": world, "mesh": eng.mesh_tag, "layers": cfg.n_layers,
                "rules": {a: eng.rules.lookup(a) for a in
                          ("heads", "kv_heads", "ffn", "experts", "vocab", "ssm_heads",
                           "conv_dim")},
                "pools": [list(p.shape) for p in pools],
                "streams": {str(r.rid): [int(t) for t in r.output] for r in done},
                "admission": admission, "sizes": [p._cache_size() for p in progs],
                "captures": sum(p.captures for p in progs),
                "launches": {fn.__name__: fn.launches for fn in counters},
                "param_gb": sum(t.numel() * t.element_size()
                                for t in _leaves(eng.params)) / 1e9,
                "pool_gb": sum(p.numel() * p.element_size() for p in pools) / 1e9,
                "leaf_gb": full_leaf_bytes(cfg) / 1e9,
                "init_s": init_s, "init_peak_gb": init_peak / 1e9,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "tokens_per_s": s["tokens_per_s"], "wall_s": s["wall_s"],
                "steps": int(s["chunk_steps"] + s["decode_only_steps"]),
                "drained": eng.cache.alloc.num_used == 0,
            }
            # the programs too: they hold their last inputs, this model's
            # parameters and pools, which the next model's peak must not see
            del eng, done, progs
        with open(out_path, "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()


def forced_check(torch, label, served, router, streams):
    """Teacher-forced replay of greedy `streams` ({rid: tokens}) through
    the tp = 1 engine on `router`'s lanes, eagerly, on the same prompts
    and runtime: the same schedule (it depends on lengths alone), every
    drawn token replaced by the stream's, so each logit row is the one the
    stream's prefix gives under the engine's own grouping (the MoE's
    capacity groups are the packed chunk and the slot batch, not a
    prompt).  Every token must be that row's argmax wherever its top-2
    margin exceeds FIRST_TOKEN_MARGIN.  -> (tokens compared, tokens)."""
    from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig

    model, params, prompts = served
    gc.collect()
    eng = ContinuousEngine(model, params, RuntimeConfig(**SERVE_RUNTIME, cuda_graphs=False),
                           router=router, device=DEVICE)
    name = "decode_step_slots" if eng.family == "ssm" else "decode_step_paged"
    step_fn = getattr(model, name)
    seen = {}

    def capture(*a, **kw):
        seen["decode"] = step_fn(*a, **kw)
        return seen["decode"]

    rows, want = [], []
    orig = eng.adapter.dispatch

    def dispatch(params_, dec_rids, lengths, last_tok, chunks, dec_sampling, dec_keys):
        nxt, seg = orig(params_, dec_rids, lengths, last_tok, chunks, dec_sampling,
                        dec_keys)
        for slot, rid in enumerate(dec_rids):
            if rid is not None:
                j = len(eng.scheduler.slots[slot].output)
                rows.append(seen["decode"][slot, -1].float())
                want.append((rid, j))
                nxt[slot] = streams[rid][j]
        for i, (req, start, n) in enumerate(chunks):
            if start + n == req.prompt_len:
                rows.append(eng.adapter.last_seg_logits[i].float())
                want.append((req.rid, 0))
                seg[i] = streams[req.rid][0]
        return nxt, seg

    setattr(model, name, capture)
    try:
        eng.adapter.dispatch = dispatch
        for p in prompts:
            eng.submit(p)
        t0 = time.perf_counter()
        done = eng.run()
    finally:
        delattr(model, name)
    if {r.rid: r.output for r in done} != streams:
        raise AssertionError(f"[{label}] the forced replay did not reproduce the streams")
    top2 = torch.topk(torch.stack(rows), 2)
    margins = (top2.values[:, 0] - top2.values[:, 1]).cpu().tolist()
    best = top2.indices[:, 0].cpu().tolist()
    compared = 0
    for (rid, j), m, b in zip(want, margins, best):
        if m > FIRST_TOKEN_MARGIN:
            compared += 1
            if b != streams[rid][j]:
                raise AssertionError(
                    f"[{label}] request {rid} token {j}: {streams[rid][j]} vs "
                    f"{b} on the replay at margin {m:.3f}")
    log(f"[{label}] every token against the tp = 1 torch lanes, teacher-forced "
        f"({time.perf_counter() - t0:.1f} s, {len(want)} tokens): {compared} had a "
        f"top-2 margin > {FIRST_TOKEN_MARGIN}, all agree; the widest margin "
        f"{max(margins):.3f}")
    return compared, len(want)


def phase_tp_families(torch, counters):
    """Phase 22 (see the comment above).  -> launches per path: each
    model's tp_mesh(1) run's and each rank's."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import tp_mesh
    from repro_torch.serve.router import PlanRouter

    t_phase = time.perf_counter()
    paths, eager = {}, {}
    for arch in TP_FAMILY_ARCHS:
        cfg = tp_family_cfg(arch)             # the ranks' depth
        served = _family_setup(torch, cfg)
        router = family_router(cfg)
        kw = dict(prompts=served[2], require_packing=cfg.family != "ssm")

        def run(label, **more):
            for fn in counters:
                fn.launches = 0
            out, first, s = serve(torch, served, router, f"{arch} {label}", **kw, **more)
            return out, first, s, {fn.__name__: fn.launches for fn in counters}

        base = run("no mesh, graphed")
        if dist.is_initialized():
            raise AssertionError("[tp families] a process group is already up")
        mesh = tp_mesh(1)
        try:
            one = run("tp_mesh(1), graphed", mesh=mesh, rules=DEFAULT_RULES)
            eager[arch] = run("tp_mesh(1), eager", mesh=mesh, rules=DEFAULT_RULES,
                              graphs=False)
        finally:
            dist.destroy_process_group()
        if one[0] != base[0] or not _same_firsts(one[1], base[1]) or one[3] != base[3]:
            raise AssertionError(
                f"[{arch}] tp_mesh(1) differs from no mesh: streams {one[0] == base[0]}, "
                f"launches {one[3]} vs {base[3]}, first divergence "
                f"{_first_divergence(base[0], one[0])}")
        need = ("matmul_fused", "sample_draw") + (
            () if cfg.family == "ssm" else ("paged_decode_attention",
                                            "paged_prefill_attention"))
        if any(eager[arch][3][k] <= 0 for k in need):
            raise AssertionError(f"[{arch}] the tp = 1 eager run launched "
                                 f"{eager[arch][3]}: a kernel of {need} never ran")
        log(f"[{arch}] tp_mesh(1) = no mesh: streams, first-token logits (bitwise) and "
            f"launches {one[3]}")
        paths[f"serve_{arch}_tp_mesh1"] = one[3]
        del served, base, one
        free_device(torch)

    build.build_all()                          # every library in place before spawning
    tmp = tempfile.mkdtemp(prefix="tp_family_worlds_")
    t0 = time.perf_counter()
    worlds = _tp_worlds(TP_SERVE_WIDTHS, tmp, "--tp-family-child", "families")
    log(f"[tp={', '.join(map(str, TP_SERVE_WIDTHS))}] worlds side by side served "
        f"{len(TP_FAMILY_ARCHS)} models in {time.perf_counter() - t0:.1f} s (start "
        f"included), at depths {TP_FAMILY_CHILD_LAYERS}")

    # every rank's numbers first, so a failing gate still leaves them all
    for arch in TP_FAMILY_ARCHS:
        for tp, ranks in worlds.items():
            for res in (r[arch] for r in ranks):
                log(f"[{arch} tp={tp}] rank {res['rank']} ({res['mesh']}, rules "
                    f"{res['rules']}, pools {res['pools']}): {res['steps']} steps, "
                    f"{res['tokens_per_s']:.1f} tokens/s in {res['wall_s']:.2f} s, "
                    f"programs {res['sizes']} (at admission {res['admission']}, captures "
                    f"{res['captures']}), launches {res['launches']}; params "
                    f"{res['param_gb']:.3f} GB drawn in {res['init_s']:.1f} s (peak "
                    f"{res['init_peak_gb']:.2f} GB), pools {res['pool_gb']:.3f} GB, peak "
                    f"{res['peak_gb']:.2f} GB against shards + one f32 full leaf and its "
                    f"f32 shard {res['param_gb'] + res['leaf_gb'] * (1 + 1 / tp):.2f} GB")
    for arch in TP_FAMILY_ARCHS:
        cfg = tp_family_cfg(arch)
        ref = eager[arch][0]
        to_check = {}
        for tp, ranks in worlds.items():
            ranks = [res[arch] for res in ranks]
            for res in ranks[1:]:
                if res["streams"] != ranks[0]["streams"]:
                    raise AssertionError(f"[{arch} tp={tp}] rank {res['rank']}'s streams "
                                         "differ from rank 0's")
            for res in ranks:
                if (res["sizes"] != [1, 1] or res["admission"] != [0, 0]
                        or res["captures"] != 0 or not res["drained"]):
                    raise AssertionError(f"[{arch} tp={tp}] rank {res['rank']}: programs "
                                         f"{res['sizes']}, admission {res['admission']}, "
                                         f"captures {res['captures']}, drained "
                                         f"{res['drained']}")
                # the same host logic on the same requests: the same steps
                # at the same shapes as the tp = 1 eager run
                want = {k: eager[arch][3][k] for k in res["launches"]}
                if res["launches"] != want:
                    raise AssertionError(f"[{arch} tp={tp}] rank {res['rank']}: launches "
                                         f"{res['launches']}, tp = 1 eager {want}")
                if res["peak_gb"] > res["param_gb"] + res["leaf_gb"] * (1 + 1 / tp):
                    raise AssertionError(f"[{arch} tp={tp}] rank {res['rank']}: peak "
                                         f"{res['peak_gb']:.2f} GB > shards + one full "
                                         "leaf and its shard in f32")
                paths[f"serve_{arch}_tp{tp}_rank{res['rank']}"] = res["launches"]
            out = {int(k): v for k, v in ranks[0]["streams"].items()}
            if sorted(out) != sorted(ref) or any(
                    len(v) != SERVE_RUNTIME["max_new_tokens"] for v in out.values()):
                raise AssertionError(f"[{arch} tp={tp}] requests {sorted(out)} unfinished")
            same = sum(out[r] == ref[r] for r in ref)
            log(f"[{arch} tp={tp}] streams equal on every rank; {same}/{len(ref)} "
                f"identical to the tp=1 eager run's, first divergence "
                f"{_first_divergence(ref, out)}")
            to_check[tp] = out
        served = _family_setup(torch, cfg)
        for tp, out in to_check.items():
            forced_check(torch, f"{arch} tp={tp}", served, PlanRouter(None), out)
        del served
        free_device(torch)
    _phase_end("tp families", t_phase)
    return paths


# ------------------------------------------------------------ phase 23
# The fixed-batch loop on a mesh: zamba2-1.2b (12 of its 38 layers: an
# earlier path, cut for the script's time) and whisper-base (1500 audio
# frames) at full width (random weights from seed 0), each one
# batch of FIXED_BATCH prompts (the first of HYBRID_FIXED_LENS /
# ENCDEC_FIXED_LENS) through FixedBatchEngine under the guarded rules
# (`PlanRouter(None).serve_rules`: whisper's odd vocabulary splits the LM
# head's rows, "embed_vec").  (a) In this process: no mesh and tp_mesh(1),
# bitwise equal (streams, first-token logits, launches: the draw kernel
# only).  (b) tp = 2 and 4 as gloo worlds of processes sharing the card
# (`--tp-fixed-child`), each rank serving both models in turn, each drawn
# straight into the rank's shards (`init_serving(..., tp=)` through the
# engine's params callable): streams equal on every rank, draw-kernel
# launches equal to the tp = 1 run's, each rank's peak within its shards +
# its caches + the larger of one f32 full leaf (init draws one part in
# f32) and the tp = 1 run's transient beyond its caches (the activations:
# whisper's encoder at 1500 frames outgrows its largest leaf).  (c) Each width's streams replayed
# teacher-forced through the tp = 1 loop on this process's model
# (`teacher_forced_rows`): every token whose top-2 margin there exceeds
# 0.25 must be its argmax.  Logged, not gated: streams equal to tp = 1's,
# params / caches / peak GB and tokens/s per rank (host-staged gloo on one
# card: no TP speed).
TP_FIXED_ARCHS = (("zamba2-1.2b", HYBRID_FIXED_LENS, HYBRID_FIXED_SEQ, None),
                  ("whisper-base", ENCDEC_FIXED_LENS, ENCDEC_FIXED_SEQ, "audio_embeds"))
TP_FIXED_LAYERS = {"zamba2-1.2b": 12}      # of 38: cut for the script's time


def tp_fixed_cfg(arch):
    """A phase-23 model's config: whisper-base whole, zamba2-1.2b at
    TP_FIXED_LAYERS (two uses of its shared block)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=TP_FIXED_LAYERS.get(arch, cfg.n_layers))


def fixed_mesh_inputs(cfg, lens, extras_key):
    """(prompts, extras) of a phase-23 model: the first FIXED_BATCH
    lengths of `lens` and, with `extras_key`, enc_seq frames, from seed 2
    (the draws of phases 12 / 13)."""
    import numpy as np

    rng = np.random.default_rng(2)
    extras = None
    if extras_key:
        extras = {extras_key: rng.standard_normal((cfg.enc_seq, cfg.d_model)
                                                  ).astype(np.float32)}
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in lens[:FIXED_BATCH]]
    return prompts, extras


def fixed_rules(cfg, mesh):
    """The guarded rules phase 23 serves under."""
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.serve.router import PlanRouter

    return PlanRouter(None).serve_rules(DEFAULT_RULES, mesh, cfg, "decoder")


def tp_fixed_child(torch, rank, world, store, out_path):
    """One rank of phase 23 (b), run as `chip_smoke.py --tp-fixed-child
    RANK WORLD STORE OUT`: both models in turn, each drawn from seed 0
    straight into the rank's shards and served by FixedBatchEngine on
    `tp_mesh(world)`; writes each model's streams, launches, memory and
    times to OUT as JSON."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_file_world, tp_mesh
    from repro_torch.models import build_model
    from repro_torch.serve.engine import FixedBatchEngine, ServeConfig

    torch.cuda.set_device(0)
    torch.cuda.init()
    init_file_world(store, rank, world, "gloo")
    results = {}
    try:
        mesh = tp_mesh(world)
        for arch, lens, max_seq, extras_key in TP_FIXED_ARCHS:
            cfg = tp_fixed_cfg(arch)
            model = build_model(cfg)
            prompts, extras = fixed_mesh_inputs(cfg, lens, extras_key)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device=DEVICE).manual_seed(0)
            t0 = time.perf_counter()
            eng = FixedBatchEngine(
                model, lambda tp: model.init_serving(gen, tp=tp),
                ServeConfig(batch_size=FIXED_BATCH, max_seq=max_seq,
                            max_new_tokens=SERVE_RUNTIME["max_new_tokens"]),
                extras, device=DEVICE, mesh=mesh, rules=fixed_rules(cfg, mesh))
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            init_peak = torch.cuda.max_memory_allocated()
            caches = model.init_cache(FIXED_BATCH, max_seq, device="meta", tp=eng.tp)
            for p in prompts:
                eng.submit(p)
            counters = _serve_counters()
            _zeroed(counters)
            dist.barrier()
            t0 = time.perf_counter()
            done = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            results[arch] = {
                "rank": rank, "world": world,
                "rules": {a: eng.rules.lookup(a) for a in
                          ("heads", "kv_heads", "ffn", "vocab", "embed_vec", "ssm_heads",
                           "conv_dim")},
                "cache_shapes": {k: list(v.shape) for k, v in caches.items()},
                "streams": {str(r.rid): [int(t) for t in r.output] for r in done},
                "launches": _launched(counters),
                "param_gb": sum(t.numel() * t.element_size()
                                for t in _leaves(eng.params)) / 1e9,
                "cache_gb": sum(v.numel() * v.element_size()
                                for v in caches.values()) / 1e9,
                "leaf_gb": full_leaf_bytes(cfg) / 1e9,
                "init_s": init_s, "init_peak_gb": init_peak / 1e9,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "tokens_per_s": eng.throughput(), "prefill_s": eng.stats["prefill_s"],
                "wall_s": wall,
            }
            del eng, done
        with open(out_path, "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()


def phase_tp_fixed(torch):
    """Phase 23 (see the comment above).  -> launches per path: each
    model's tp_mesh(1) run's and each rank's."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import tp_mesh

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    counters = _serve_counters()
    paths, served = {}, {}
    for arch, lens, max_seq, extras_key in TP_FIXED_ARCHS:
        cfg = tp_fixed_cfg(arch)
        model, params = family_setup(torch, cfg)
        prompts, extras = fixed_mesh_inputs(cfg, lens, extras_key)

        def run(label, **kw):
            _zeroed(counters)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            out, first, tps, _ = fixed_serve(torch, model, params, prompts,
                                             f"{arch} {label}", max_seq, extras,
                                             loop=True, **kw)
            return (out, first, tps, _launched(counters),
                    torch.cuda.max_memory_allocated() - held)

        base = run("no mesh")
        caches = model.init_cache(FIXED_BATCH, max_seq, device="meta")
        # what the loop allocates beyond its caches on one device: the
        # activations, which a rank's (split) run does not exceed
        act_gb = (base[4] - sum(v.numel() * v.element_size()
                                for v in caches.values())) / 1e9
        if dist.is_initialized():
            raise AssertionError("[tp fixed] a process group is already up")
        mesh = tp_mesh(1)
        try:
            one = run("tp_mesh(1)", mesh=mesh, rules=fixed_rules(cfg, mesh))
        finally:
            dist.destroy_process_group()
        if (one[0] != base[0] or not _same_firsts(one[1], base[1]) or one[3] != base[3]
                or set(one[3]) != {"sample_draw"}):
            raise AssertionError(
                f"[{arch}] tp_mesh(1) differs from no mesh: streams {one[0] == base[0]}, "
                f"launches {one[3]} vs {base[3]}, first divergence "
                f"{_first_divergence(base[0], one[0])}")
        log(f"[{arch}] FixedBatchEngine on tp_mesh(1) = no mesh: streams, first-token "
            f"logits (bitwise) and launches {one[3]}; tokens/s {one[2]:.1f} vs "
            f"{base[2]:.1f}; the run's transient beyond its caches {act_gb:.3f} GB")
        paths[f"fixed_{arch}_tp_mesh1"] = one[3]
        served[arch] = (model, params, prompts, extras, max_seq, one, act_gb)

    build.build_all()                          # every library in place before spawning
    tmp = tempfile.mkdtemp(prefix="tp_fixed_worlds_")
    t0 = time.perf_counter()
    worlds = _tp_worlds(TP_SERVE_WIDTHS, tmp, "--tp-fixed-child", "fixed")
    log(f"[tp={', '.join(map(str, TP_SERVE_WIDTHS))}] worlds side by side served "
        f"{len(TP_FIXED_ARCHS)} models through FixedBatchEngine in "
        f"{time.perf_counter() - t0:.1f} s (start included)")
    def allowed(res, act_gb):
        return res["param_gb"] + res["cache_gb"] + max(res["leaf_gb"], act_gb)

    for arch, *_ in TP_FIXED_ARCHS:           # every rank's numbers first
        for tp, ranks in worlds.items():
            for res in (r[arch] for r in ranks):
                log(f"[{arch} tp={tp}] rank {res['rank']} (rules {res['rules']}, caches "
                    f"{res['cache_shapes']}): {res['tokens_per_s']:.1f} tokens/s, prefill "
                    f"{res['prefill_s']:.3f} s, wall {res['wall_s']:.2f} s, launches "
                    f"{res['launches']}; params {res['param_gb']:.3f} GB drawn in "
                    f"{res['init_s']:.1f} s (peak {res['init_peak_gb']:.2f} GB), caches "
                    f"{res['cache_gb']:.3f} GB, peak {res['peak_gb']:.2f} GB against "
                    f"shards + caches + max(one f32 full leaf {res['leaf_gb']:.3f}, "
                    f"tp = 1's transient {served[arch][6]:.3f}) = "
                    f"{allowed(res, served[arch][6]):.2f} GB")
    for arch, *_ in TP_FIXED_ARCHS:
        model, params, prompts, extras, max_seq, one, act_gb = served[arch]
        ref = one[0]
        for tp, ranks in worlds.items():
            ranks = [res[arch] for res in ranks]
            for res in ranks[1:]:
                if res["streams"] != ranks[0]["streams"]:
                    raise AssertionError(f"[{arch} tp={tp}] rank {res['rank']}'s streams "
                                         "differ from rank 0's")
            for res in ranks:
                if res["launches"] != one[3]:
                    raise AssertionError(f"[{arch} tp={tp}] rank {res['rank']}: launches "
                                         f"{res['launches']}, tp = 1 {one[3]}")
                if res["peak_gb"] > allowed(res, act_gb):
                    raise AssertionError(f"[{arch} tp={tp}] rank {res['rank']}: peak "
                                         f"{res['peak_gb']:.2f} GB > shards + caches + "
                                         "max(one full leaf, tp = 1's transient)")
                paths[f"fixed_{arch}_tp{tp}_rank{res['rank']}"] = res["launches"]
            out = {int(k): v for k, v in ranks[0]["streams"].items()}
            if sorted(out) != sorted(ref) or any(
                    len(v) != SERVE_RUNTIME["max_new_tokens"] for v in out.values()):
                raise AssertionError(f"[{arch} tp={tp}] requests {sorted(out)} unfinished")
            same = sum(out[r] == ref[r] for r in ref)
            t0 = time.perf_counter()
            rows = teacher_forced_rows(torch, model, params, prompts, max_seq, out, extras)
            n_first, n_all = margin_agree(f"{arch} tp={tp}", rows, out,
                                          "the tp = 1 replay")
            log(f"[{arch} tp={tp}] streams equal on every rank; {same}/{len(ref)} "
                f"identical to tp = 1's, first divergence {_first_divergence(ref, out)}; "
                f"against the tp = 1 loop teacher-forced ({time.perf_counter() - t0:.1f} s):"
                f" {n_all}/{len(rows)} tokens ({n_first} first tokens) had a top-2 margin > "
                f"{FIRST_TOKEN_MARGIN}, all agree")
        del model, params
        served[arch] = None
    _phase_end("tp fixed", t_phase)
    return paths


# ------------------------------------------------------------ phase 24
# Training on a mesh (`Trainer(model, mesh, rules, data, cfg)`, the rank
# step `launch/steps.py::mesh_train_step`), every world a gloo world of
# processes sharing the card (`--train-tp-child RANK WORLD STORE OUT JOB`):
#   (a) qwen3-1.7b at phase 14's configuration, cut to TRAIN_TP_LAYERS
#       layers (of 28; an earlier path, cut for the script's time;
#       the same no-mesh reference as (b)'s qwen3), on a (data 1, model 2) and a (data 2, model 1) mesh with
#       ZeRO-1, worlds of two;
#   (b) the layouts of ROADMAP item 8c-ii, one world of LAYOUT_WORLD
#       processes after (a)'s two, which run side by side (LAYOUT_RUNS;
#       its qwen3 ranks beside (a)'s (data 1, model 2) world took the
#       card's 80 GB): qwen3-1.7b on
#       (pod 2, data 2, model 1), the batch over pod x data, ZeRO-1 over
#       data; zamba2-1.2b on (data 2, model 2) with one 16,384-token
#       sequence, "seq" over "data" (the batch replicated: the SSD's fold,
#       the conv's halo and the shared attention's K / V across the ranks).
# Every rank draws the single-device state from seed 0 and keeps its cut,
# computes the step-1 gradients (held against this process's no-mesh step
# at the same depth, whose gradients it leaves on the host: loss within
# TRAIN_TP_LOSS_ATOL, norm within TRAIN_TP_GNORM_RTOL, every leaf's cosine
# >= TRAIN_TP_COSINE) and runs TRAIN_TP_STEPS steps (the same bits on
# every rank); the (data 1, model 2) world then trains phase 15's Trainer
# configuration for ELASTIC_STEPS steps and saves, and this process
# restores that checkpoint with no mesh (elastic restart: phase 15's size,
# as the full 24.4 GB f32 state would take minutes of disk).  "expert_ffn"
# in training needs n_experts % model != 0: qwen2-moe's 60 experts divide
# 2 and 4, so one card checks it on the CPU only
# (tests/test_torch_train_layouts.py).
TRAIN_TP_MESHES = ((1, 2), (2, 1))
TRAIN_TP_LAYERS = 2
TRAIN_TP_STEPS = 1
TRAIN_TP_LOSS_ATOL, TRAIN_TP_GNORM_RTOL, TRAIN_TP_COSINE = 1e-3, 1e-2, 0.999
ELASTIC_STEPS = 4
LAYOUT_WORLD = 4
# name -> (arch, layers, mesh shape, sequence, global batch, microbatches)
LAYOUT_RUNS = {
    "pod 2 x data 2 x model 1": ("qwen3-1.7b", 2, (2, 2, 1), TRAIN_SEQ, TRAIN_BATCH,
                                 TRAIN_MICROBATCHES),
    "data 2 x model 2, seq over data": ("zamba2-1.2b", 6, (2, 2), 16_384, 1, 1),
}


def _wrappers():
    """The eight hand-written kernels' wrappers (their launch counters)."""
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import conv2d as KC
    from repro_torch.kernels import fused as KF
    from repro_torch.kernels import matmul as KM
    from repro_torch.kernels import sampling as KS

    return (KA.paged_decode_attention, KA.paged_prefill_attention, KM.matmul_fused,
            KC.conv2d_direct, KF.fused_elementwise, KA.flash_attention,
            KA.dense_decode_attention, KS.sample_draw)


def train_tp_reckon(cfg, state, rows, seq, tp, keys=None):
    """Bytes one rank needs before the run, from its shards: parameters,
    gradients (the parameters' shapes), moments (as cut, ZeRO-1 blocks
    included), and activations under remat full for `rows` rows of `seq`
    positions a microbatch attending to `keys` positions (default `seq`):
    each layer's input kept (bf16), one layer recomputed in backward
    (attention's f32 logits and probabilities of the rank's heads over
    the keys, or over one key chunk where `_sdpa` takes the chunked form,
    its MLP's four (rows, seq, d_ff / tp) bf16 tensors, or for the SSM
    layers the SSD's three (chunk x chunk) f32 tensors a head and chunk,
    the largest) and one LM-head chunk (512 positions' f32 logits over the
    rank's vocabulary, three times: logits, exponentials, gradient)."""
    from repro_torch.models.attention import _CHUNKED_KV_THRESHOLD, _kv_chunk_for

    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in _leaves(tree))
    params, moments = nbytes(state["params"]), nbytes(state["opt"]["m"]) * 2
    d, keys = cfg.d_model, keys or seq
    chunk = _kv_chunk_for(keys) if keys >= _CHUNKED_KV_THRESHOLD else 0
    span = chunk if chunk and keys // chunk > 1 else keys
    kept = cfg.n_layers * rows * seq * d * 2
    layer = max(rows * (cfg.n_heads // tp) * seq * span * (4 + 4 + 2),
                4 * rows * seq * (cfg.d_ff // tp) * 2)
    if cfg.ssm_state:
        heads = cfg.ssm_expand * d // cfg.ssm_head_dim // tp
        layer = max(layer, 3 * rows * heads * seq * cfg.ssm_chunk * 4)
    head = 3 * rows * 512 * (cfg.vocab // tp) * 4
    return {"params": params, "grads": params, "moments": moments,
            "activations": kept + layer + head}


def _dots(torch, a, b, piece=1 << 24):
    """(a . b, a . a, b . b) of two f32 tensors, f32 products over pieces
    of `piece` elements summed in f64 (no f64 copy of either)."""
    out = torch.zeros(3, dtype=torch.float64, device=a.device)
    for x, y in zip(a.reshape(-1).split(piece), b.reshape(-1).split(piece)):
        x, y = x.float(), y.float()
        out += torch.stack([x @ y, x @ x, y @ y]).double()
    return out


def _sha(torch, t):
    """sha256 of a tensor's bytes."""
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()


def _least_free(torch):
    """Start a thread that reads the card's free memory
    (`torch.cuda.mem_get_info`: what every process on it leaves) every 2
    ms; -> a function that stops it and returns the least free bytes
    read."""
    import threading

    least, stop = [float("inf")], threading.Event()

    def poll():
        torch.cuda.set_device(0)
        while not stop.is_set():
            least[0] = min(least[0], torch.cuda.mem_get_info(0)[0])
            stop.wait(0.002)

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()

    def done():
        stop.set()
        thread.join()
        return least[0]

    return done


def _train_cfg(arch, layers):
    """`arch` at full width, remat full, `layers` deep."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), remat="full", n_layers=layers)


def _train_mesh(torch, world, shape):
    """A DeviceMesh of the world's ranks: (data, model) or (pod, data,
    model)."""
    from torch.distributed.device_mesh import DeviceMesh

    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return DeviceMesh(DEVICE, torch.arange(world).reshape(tuple(shape)),
                      mesh_dim_names=names)


def _train_mesh_run(torch, world, run, tmp):
    """One mesh of a phase-24 world: the Trainer over RUN's mesh (arch,
    layers, shape, seq, batch, microbatches), the state drawn from seed 0
    and cut, step 1's gradients against RUN's kept no-mesh ones (cosines on
    the ranks that own each position), TRAIN_TP_STEPS steps; -> its
    numbers."""
    import torch.distributed as dist

    from repro_torch.configs import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch.steps import TrainConfig, rules_for_shape
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import tree_flatten_with_paths

    res = {}
    mesh = _train_mesh(torch, world, run["shape"])
    cfg = _train_cfg(run["arch"], run["layers"])
    rules = rules_for_shape(cfg, ShapeSpec("train", "train", run["seq"], run["batch"]), mesh)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=run["seq"],
                                      global_batch=run["batch"]))
    tr = Trainer(build_model(cfg), mesh, rules, data, TrainerConfig(
        steps=TRAIN_TP_STEPS, ckpt_every=10 ** 9, log_every=10 ** 9,
        ckpt_dir=os.path.join(tmp, f"ckpt_unused_{dist.get_rank()}"),
        train=TrainConfig(microbatches=run["k"], zero1=True,
                          opt=AdamWConfig(**TRAIN_OPT))))
    step, rm = tr._step_fn, tr.rank_mesh
    wrappers = _wrappers()
    _zeroed(wrappers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = tr.init_state(0)
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    rows = run["batch"] // run["k"] // (rm.batch.size if rm.batch is not None else 1)
    seq = run["seq"] // (rm.seq.size if rm.seq is not None else 1)
    res["reckon"] = train_tp_reckon(cfg, state, rows, seq,
                                    rm.tp.size if rm.tp is not None else 1, run["seq"])
    res["rules"] = {a: rm.rules.lookup(a) for a in ("batch", "seq", "zero", "heads",
                                                   "kv_heads", "ffn", "vocab",
                                                   "ssm_heads")}
    cuts, cos = dict(tree_flatten_with_paths(step.layouts["params"])), {}

    def against_reference(grads):
        # step 1's gradients against the no-mesh step's, leaf by leaf: each
        # rank takes the dot product and the squared norms over the positions
        # it owns of the reference leaf's cut as its own, summed over the
        # model axis (the other axes hold the same whole gradients)
        t0 = time.perf_counter()
        keys, sums = [], []
        for key, g in tree_flatten_with_paths(grads):
            cut = cuts[key]
            ref = cut.model_local(kept_leaf(torch, run["grads"], key))
            if cut.dim is not None and len(cut.owned()) < len(cut.index):
                own = cut.owned().to(g.device)
                g, ref = g.index_select(cut.dim, own), ref.index_select(cut.dim, own)
            part = _dots(torch, g, ref)
            if cut.dim is None and rm.tp is not None and rm.tp.rank != 0:
                part = torch.zeros_like(part)
            keys.append(key)
            sums.append(part.float())
            del ref
        sums = torch.stack(sums)
        if rm.tp is not None:
            sums = rm.tp.all_reduce(sums)
        for key, (ab, aa, bb) in zip(keys, sums.double().tolist()):
            cos[key] = ab / math.sqrt(aa * bb)
        res["compare_s"] = time.perf_counter() - t0

    losses, norms, ms = [], [], []
    least_free = _least_free(torch)
    for i in range(TRAIN_TP_STEPS):
        batch = tr._batch(i)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        state["params"], state["opt"], met = step(
            state["params"], state["opt"], batch,
            on_grads=against_reference if i == 0 else None)
        losses.append(float(met["loss"]).hex())
        norms.append(float(met["grad_norm"]).hex())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 - (res["compare_s"] * 1e3 if i == 0
                                                     else 0.0))
    res.update(cosines=cos, n_leaves=len(cuts), losses=losses, norms=norms, step_ms=ms,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               least_free_gib=least_free() / 2 ** 30,
               launches={fn.__name__: fn.launches for fn in wrappers})
    res["replicated"] = {k: _sha(torch, t)
                         for k, t in tree_flatten_with_paths(state["params"])
                         if cuts[k].dim is None}
    del state, tr, step
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_tp_child(torch, rank, world, store, out_path, job_path):
    """One rank of phase 24, run as `chip_smoke.py --train-tp-child RANK
    WORLD STORE OUT JOB`: JOB's entry for this world's size, each of its
    runs in turn (`_train_mesh_run`, every run's mesh over the same
    ranks); with "elastic", the Trainer run on the (data 1, model 2) mesh
    that saves.  Writes its numbers to OUT as JSON."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_file_world
    from repro_torch.tree import tree_flatten_with_paths

    with open(job_path) as f:
        job = json.load(f)[str(world)]
    torch.cuda.set_device(0)
    torch.cuda.init()
    init_file_world(store, rank, world, "gloo")
    res = {"rank": rank, "runs": {}}
    try:
        for name, run in job["runs"].items():
            t0 = time.perf_counter()
            res["runs"][name] = _train_mesh_run(torch, world, run, job["tmp"])
            res["runs"][name]["run_s"] = time.perf_counter() - t0
        if job.get("elastic"):
            etr = _loop_trainer(job["elastic_dir"], mesh=_train_mesh(torch, world, (1, 2)),
                                steps=ELASTIC_STEPS)
            _, st, _ = etr.run()
            full = etr.full_state(st)
            if etr.rank_mesh.writer:
                np.savez(job["elastic_npz"], **{k: t.cpu().numpy() for k, t in
                                                tree_flatten_with_paths(full)})
            res["elastic_loss"] = etr.metrics_log[-1]["loss"]
        with open(out_path, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def train_memory_history(torch):
    """`--train-memory`: one (data 2, model 1) rank's train step alone in
    this process (qwen3-1.7b at phase 14's configuration, the rank's 4
    rows, 2 microbatches; `make_train_step`, so AdamW on whole leaves, and
    no data-parallel sum), run once to warm up, then once under the
    allocator's history (`torch.cuda.memory._record_memory_history`): the
    history replayed to its peak, and the blocks live there beyond what
    was resident before the step, by size and by the innermost frame of
    this repo (allocations on autograd's device thread have none)."""
    import collections

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.launch.steps import TrainConfig, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    def where(ev):
        for f in ev.get("frames") or ():
            if "repro_torch" in f["filename"] or "chip_smoke" in f["filename"]:
                return f"{os.path.basename(f['filename'])}:{f['line']}:{f['name']}"
        return "(no frame of this repo: autograd's thread)"

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), remat="full")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    opt = adamw_init(params)
    step = make_train_step(model, TrainConfig(microbatches=TRAIN_MICROBATCHES,
                                              opt=AdamWConfig(**TRAIN_OPT)), DEFAULT_RULES)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH // 2))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(0).items()}
    params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=3_000_000, stacks="python")
    params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    events = torch.cuda.memory._snapshot()["device_traces"][0]
    torch.cuda.memory._record_memory_history(enabled=None)
    cur, best, best_i = base, base, -1
    live = {}
    for i, ev in enumerate(events):
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]
        if cur > best:
            best, best_i = cur, i
    live = {}
    for ev in events[:best_i + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] == "free_requested":
            live.pop(ev["addr"], None)
    groups = collections.defaultdict(lambda: [0, 0])
    for ev in live.values():
        group = groups[(where(ev), ev["size"])]
        group[0] += 1
        group[1] += ev["size"]
    log(f"[train memory] {len(events)} allocator events; resident before the step "
        f"{base / 1e9:.3f} GB (parameters, moments); the history's peak "
        f"{best / 1e9:.3f} GB at event {best_i} (max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB); "
        f"{time.perf_counter() - t0:.1f} s")
    for (at, size), (n, total) in sorted(groups.items(), key=lambda kv: -kv[1][1])[:20]:
        log(f"[train memory]   {total / 1e9:8.3f} GB = {n:4d} x {size:12d} B  {at}")
    log(f"[train memory] live at the peak beyond the resident: {(best - base) / 1e9:.3f} GB "
        f"in {len(live)} blocks")


def _step1_reference(torch, arch, layers, seq, batch, k, keep):
    """The no-mesh bf16 step 1 of `arch` at `layers` layers (full width,
    remat full, seed 0, the pipeline's batch 0 of `batch` x `seq`, `k`
    microbatches) in this process: its gradients left on the host in
    `keep` (`keep_leaf`); -> {"loss1", "gnorm1", "peak_gb", "s"}."""
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import build_model
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_flatten_with_paths

    t0 = time.perf_counter()
    cfg = _train_cfg(arch, layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch))
    torch.cuda.reset_peak_memory_stats()
    loss, _, grads = loss_and_grads(model, params, _train_batch(torch, data, 0, cfg), k)
    gnorm = float(global_norm(grads))
    for key, g in tree_flatten_with_paths(grads):
        keep_leaf(torch, keep, key, g)
    out = {"loss1": float(loss), "gnorm1": gnorm,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "s": time.perf_counter() - t0}
    del model, params, grads
    free_device(torch)
    return out


def _check_train_world(torch, tag, ranks, name, ref):
    """Every rank's run `name` of a phase-24 world: its numbers logged
    beside its reckoning, the same bits on every rank, step 1 against the
    no-mesh reference `ref`, no hand-written launch."""
    for r in ranks:
        run, rk = r["runs"][name], r["runs"][name]["reckon"]
        total = sum(rk.values()) / 1e9
        log(f"{tag} rank {r['rank']} (rules {run['rules']}): state drawn and cut in "
            f"{run['init_s']:.1f} s; step-1 gradients gathered and compared in "
            f"{run['compare_s']:.2f} s; step ms (gloo on one card, not a DP / TP speed) "
            + ", ".join(f"{m:.1f}" for m in run["step_ms"])
            + f"; peak {run['peak_gb']:.2f} GB beside the reckoning {total:.2f} GB "
            f"(params {rk['params'] / 1e9:.2f}, grads {rk['grads'] / 1e9:.2f}, "
            f"moments {rk['moments'] / 1e9:.2f}, activations "
            f"{rk['activations'] / 1e9:.2f}); least free on the card during the "
            f"steps (every process's use) {run['least_free_gib']:.2f} GiB of "
            f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.2f} GiB; "
            f"the run {run['run_s']:.1f} s; launches {run['launches']}")
    first = ranks[0]["runs"][name]
    for r in ranks[1:]:
        for key in ("losses", "norms", "replicated"):
            if r["runs"][name][key] != first[key]:
                raise AssertionError(f"{tag} rank {r['rank']}'s {key} differ from "
                                     "rank 0's")
    loss, gnorm = float.fromhex(first["losses"][0]), float.fromhex(first["norms"][0])
    cos = next(r["runs"][name]["cosines"] for r in ranks if r["runs"][name]["cosines"])
    worst = sorted((c, k) for k, c in cos.items())
    log(f"{tag} step 1: loss {loss:.6f} (no mesh {ref['loss1']:.6f}, |d| "
        f"{abs(loss - ref['loss1']):.2e}, tol {TRAIN_TP_LOSS_ATOL}), grad_norm "
        f"{gnorm:.6f} (no mesh {ref['gnorm1']:.6f}, rel "
        f"{abs(gnorm / ref['gnorm1'] - 1):.2e}, tol {TRAIN_TP_GNORM_RTOL}); losses "
        + ", ".join(f"{float.fromhex(x):.6f}" for x in first["losses"])
        + "; the same bits on every rank (loss, grad_norm, "
        f"{len(first['replicated'])} replicated leaves after step {TRAIN_TP_STEPS})")
    log(f"{tag} gradient cosine with the no-mesh step per leaf (its bf16-rounded "
        "copy): " + ", ".join(f"{k} {c:.6f}" for c, k in worst))
    if not (abs(loss - ref["loss1"]) <= TRAIN_TP_LOSS_ATOL
            and abs(gnorm / ref["gnorm1"] - 1) <= TRAIN_TP_GNORM_RTOL
            and len(cos) == first["n_leaves"] and worst[0][0] >= TRAIN_TP_COSINE):
        raise AssertionError(f"{tag} step 1 disagrees with the no-mesh step")
    if any(n for r in ranks for n in r["runs"][name]["launches"].values()):
        raise AssertionError(f"{tag} hand-written kernels launched")


def phase_train_tp(torch, counters, smi=""):
    """Phase 24 (see the comment above): the no-mesh references in this
    process, then (a)'s two worlds side by side, then (b)'s world."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from repro_torch.tree import tree_flatten_with_paths

    label = "train tp"
    t_phase = time.perf_counter()
    _zeroed(counters)
    tmp = tempfile.mkdtemp(prefix="train_tp_")
    runs = {f"data {d} x model {m}": ("qwen3-1.7b", TRAIN_TP_LAYERS, (d, m), TRAIN_SEQ,
                                      TRAIN_BATCH, TRAIN_MICROBATCHES)
            for d, m in TRAIN_TP_MESHES}
    runs.update(LAYOUT_RUNS)
    refs, jobs = {}, {}
    try:
        for name, (arch, layers, shape, seq, batch, k) in runs.items():
            keep = os.path.join(tmp, "ref_" + re.sub(r"\W+", "_", name))
            os.makedirs(keep)
            key = (arch, layers, seq, batch, k)
            if key not in refs:
                refs[key] = dict(_step1_reference(torch, arch, layers, seq, batch, k, keep),
                                 grads=keep)
                log(f"[{label}] the no-mesh reference: {arch} at {layers} layers, "
                    f"{batch} x {seq} tokens, {k} microbatches: step-1 loss "
                    f"{refs[key]['loss1']:.6f}, grad_norm {refs[key]['gnorm1']:.6f}, peak "
                    f"{refs[key]['peak_gb']:.2f} GB, {refs[key]['s']:.1f} s")
            jobs[name] = {"arch": arch, "layers": layers, "shape": list(shape), "seq": seq,
                          "batch": batch, "k": k, "grads": refs[key]["grads"]}
        first, second = (f"data {d} x model {m}" for d, m in TRAIN_TP_MESHES)
        job_paths = []
        for tag, size, extra in (
                ("a1", 2, {"runs": {first: jobs[first]}, "elastic": True,
                           "elastic_dir": os.path.join(tmp, "elastic"),
                           "elastic_npz": os.path.join(tmp, "elastic.npz")}),
                ("a2", 2, {"runs": {second: jobs[second]}}),
                ("b", LAYOUT_WORLD, {"runs": {n: jobs[n] for n in LAYOUT_RUNS}})):
            job_paths.append(os.path.join(tmp, f"job_{tag}.json"))
            with open(job_paths[-1], "w") as f:
                json.dump({str(size): dict(extra, tmp=tmp)}, f)
        # ranks of 17 GB share the card: segments that grow in place keep
        # the allocator's cached-but-unusable bytes down
        env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            futures = [pool.submit(_tp_world, 2, tmp, "--train-tp-child", f"train_a{i}_",
                                   (job_paths[i],), env) for i in range(2)]
            world_a = [f.result() for f in futures]
        log(f"[{label}] the (data 1, model 2) and (data 2, model 1) worlds side by side: "
            f"{time.perf_counter() - t0:.1f} s (start included)")
        t0 = time.perf_counter()
        world_b = _tp_world(LAYOUT_WORLD, tmp, "--train-tp-child", "train_b_",
                            (job_paths[2],), env)
        log(f"[{label}] the {LAYOUT_WORLD}-rank world: {time.perf_counter() - t0:.1f} s "
            "(start included)")
        for name, ranks in ((first, world_a[0]), (second, world_a[1])):
            _check_train_world(torch, f"[{label} {name}]", ranks, name,
                               refs[runs[name][:2] + runs[name][3:]])
        for name in LAYOUT_RUNS:
            _check_train_world(torch, f"[{label} {name}]", world_b, name,
                               refs[runs[name][:2] + runs[name][3:]])
        log(f"[{label}] {smi}")
        # the elastic restart: the (1, 2) world saved, this process restores
        held = dict(np.load(os.path.join(tmp, "elastic.npz")))
        solo = _loop_trainer(os.path.join(tmp, "elastic"), steps=ELASTIC_STEPS)
        start, state = solo.restore_or_init()
        diff = [k for k, t in tree_flatten_with_paths(state)
                if not np.array_equal(t.cpu().numpy(), held[k])]
        log(f"[{label}] elastic restart: the (data 1, model 2) world trained phase 15's "
            f"configuration {ELASTIC_STEPS} steps (loss "
            f"{world_a[0][0]['elastic_loss']:.4f}) and saved; restored here with no "
            f"mesh at step {start}: {len(held)} leaves, "
            + ("bitwise equal to the state the ranks gathered" if not diff
               else f"{len(diff)} differ: {diff[:5]}"))
        if start != ELASTIC_STEPS or diff or set(held) != {
                k for k, _ in tree_flatten_with_paths(state)}:
            raise AssertionError(f"[{label}] the elastic restart differs")
        del state, solo
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if _launched(counters):
        raise AssertionError(f"[{label}] hand-written kernels launched: "
                             f"{_launched(counters)}")
    log(f"[{label}] hand-written kernels launched: none (this process and every rank)")
    _phase_end(label, t_phase)


def _log_device_profile(prof, wall_s, label, calls=None):
    """Device time by kernel over a traced run (torch.profiler, CUDA
    activity only), and the device's busy share of the run's wall time
    (and the device ms per call, given the run's number of `calls`)."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        # device-side events only: an eager run's host ops (aten::mm, ...)
        # also carry their kernels' device time, which would count it twice
        t_us = getattr(e, "self_device_time_total", 0) or 0
        if t_us > 0 and e.device_type == DeviceType.CUDA:
            rows.append((t_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(t for t, _, _ in rows) / 1e6
    per = "" if not calls else f", {1e3 * busy_s / calls:.4f} device ms per call"
    log(f"[{label}] profile: device busy {busy_s:.3f} s of {wall_s:.3f} s wall "
        f"({100 * busy_s / max(wall_s, 1e-9):.1f}%{per}); top kernels by device time:")
    for t_us, key, count in rows[:12]:
        log(f"[{label}]   {t_us / 1e3:10.2f} ms  {count:7d} calls  {key[:90]}")
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------ phase 25
# Serving on a (data 2, model 2) mesh (see the module docstring): the
# serving layouts of the production meshes, one world of DP_WORLD gloo
# processes sharing the card (`--dp-serve-child`).  The no-mesh runs at
# the same depths in this process are what the ranks are held to.  Logged,
# not gated: streams identical to the no-mesh run's (the TP partial sums
# round differently in bf16), params / caches / peaks and tokens/s per
# rank (host-staged gloo on one card: no data- or tensor-parallel speed).
DP_MESH = (2, 2)
DP_WORLD = 4
# the MoE and qwen3 at 2 layers since the sequence-parallel prefill joined
# the phase (4 before), zamba2 at 6 (one use of the shared block) and
# mamba2 at 4 since the training layouts joined phase 24 (12 and 8 before),
# to hold the script's time
DP_LAYERS = {"qwen2-moe-a2.7b": 2, "qwen3-1.7b": 2, "zamba2-1.2b": 6, "mamba2-2.7b": 4}
# the reference's REPRO_RULES overrides each model serves under
DP_RULES = {"qwen2-moe-a2.7b": dict(experts=None, expert_ffn="model"),
            "qwen3-1.7b": dict(kv_heads=None, kv_seq="model")}
DP_PROMPTS = 8
DP_MAX_SEQ = 768                # 700-token prompts + 32 new, positions even
# the sequence-parallel prefill's prompts (63 and 64 chunks of 256: each
# rank's block 31.5 and 32 chunks), each model's cache DP_DECODE_STEPS
# positions longer
DP_SEQ_PROMPTS = {"zamba2-1.2b": 16_128, "mamba2-2.7b": 16_384}
DP_DECODE_STEPS = 32
DP_SEQ_CHECK_STEPS = 8          # decode steps fed the no-mesh stream after prefill_step
DP_BATCH1_TOL = 0.05            # x max |logit|: bf16, TP and merged partials
# x max |leaf|: each rank's carries and K / V against the no-mesh cache's
# cut, or within DP_CACHE_TP_RATIO x the same rank's error with the whole
# prompt on every rank ("seq" whole: the TP run's own bf16 rounding)
DP_CACHE_TOL = 0.05
DP_CACHE_TP_RATIO = 2.0


def dp_cfg(arch):
    """Phase 25's configuration of `arch`: full width, the cut depth."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=DP_LAYERS[arch])


def dp_prompts(cfg):
    """The first DP_PROMPTS of phase 3's prompt lengths over the vocabulary,
    from seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
            for n in PROMPT_LENS[:DP_PROMPTS]]


def dp_rules(cfg, mesh):
    """The guarded rules with the model's DP_RULES overrides."""
    return fixed_rules(cfg, mesh).replace(**DP_RULES[cfg.name])


def seq_rules(cfg, mesh, max_seq):
    """`rules_for_shape`'s layout of a batch of one (long_500k at `max_seq`
    positions: the batch replicated, "seq", "kv_seq" and "ssm_state" over
    "data"), pruned for the mesh."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.steps import fixed_batch_rules, rules_for_shape

    shape = dataclasses.replace(SHAPES["long_500k"], seq_len=max_seq)
    return fixed_batch_rules(rules_for_shape(cfg, shape, mesh), mesh)


def _rel(got, want):
    """max |got - want| / max |want| (f32, on the host)."""
    return float((got - want).abs().max() / want.abs().max())


def dp_cache_reckoning(cfg):
    """The bytes of one rank's qwen3 cache under DP_RULES at DP_MESH: its
    FIXED_BATCH / 2 rows, DP_MAX_SEQ / 2 positions and every KV head, K
    and V in bf16, and its rows' int32 lengths."""
    rows, pos = FIXED_BATCH // DP_MESH[0], DP_MAX_SEQ // DP_MESH[1]
    return 2 * cfg.n_layers * rows * pos * cfg.n_kv_heads * cfg.hd * 2 + rows * 4


def _dp_seq_rank(torch, arch, plen, mesh, ref_path, rank):
    """One rank's sequence-parallel prefill of `arch` (DP_LAYERS deep, drawn
    from seed 0 into the rank's shards) under `seq_rules`: `prefill_step`
    on the no-mesh run's prompt in `ref_path` (its logits' digest and error,
    the rank's cache against the cut of the no-mesh cache, the prefill's
    peak beyond what the rank held before it), DP_SEQ_CHECK_STEPS decode
    steps fed the no-mesh stream (errors, margin tokens), the same prefill
    with "seq" whole (the whole prompt on every rank: the cache errors of
    tensor parallelism alone), then FixedBatchEngine at batch 1 (its
    stream and draw launches)."""
    import hashlib

    import torch.distributed as dist

    from repro_torch.configs import SHAPES
    from repro_torch.distributed.sharding import local_cache
    from repro_torch.launch.steps import ServeMesh, prefill_step, rules_for_shape, serve_step
    from repro_torch.models import build_model
    from repro_torch.serve.engine import FixedBatchEngine, ServeConfig

    cfg = dp_cfg(arch)
    model = build_model(cfg)
    max_seq = plen + DP_DECODE_STEPS
    rules = seq_rules(cfg, mesh, max_seq)
    sm = ServeMesh(mesh, rules)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init_serving(torch.Generator(device=DEVICE).manual_seed(0), tp=sm.tp)
    ref = torch.load(ref_path)
    toks = ref["prompt"].to(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dist.barrier()
    t0 = time.perf_counter()
    with sm.contexts():
        logits, cache = prefill_step(model, params, toks, max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    row = logits[0, -1].float().cpu()
    digest = hashlib.sha256(row.numpy().tobytes()).hexdigest()
    errs = [_rel(row, ref["rows"][0])]
    cut = local_cache(ref["cache"], model, rules, dict(sm.groups, model=sm.tp))
    cache_errs = {k: _rel(cache[k].float().cpu(), cut[k].float()) for k in cut
                  if k != "lengths"}
    if not torch.equal(cache["lengths"].cpu(), cut["lengths"]):
        raise AssertionError(f"[{arch} seq] rank {rank}: lengths {cache['lengths']}")
    agree = compared = 0
    t0 = time.perf_counter()
    for j, tok in enumerate(ref["stream"][:DP_SEQ_CHECK_STEPS]):
        with sm.contexts():
            logits, cache = serve_step(model, params, cache, torch.tensor(
                [[tok]], dtype=torch.int32, device=DEVICE))
        row, want = logits[0, -1].float().cpu(), ref["rows"][j + 1]
        errs.append(_rel(row, want))
        top2 = torch.topk(want, 2)
        if float(top2.values[0] - top2.values[1]) > FIRST_TOKEN_MARGIN:
            compared += 1
            agree += int(row.argmax()) == int(top2.indices[0])
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / DP_SEQ_CHECK_STEPS
    cache_shapes = {k: list(v.shape) for k, v in cache.items()}
    del cache, logits
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with ServeMesh(mesh, rules.replace(seq=None)).contexts():
        logits, cache = prefill_step(model, params, toks, max_seq)
    torch.cuda.synchronize()
    whole_peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    tp_errs = {k: _rel(cache[k].float().cpu(), cut[k].float()) for k in cache_errs}
    tp_errs["logits"] = _rel(logits[0, -1].float().cpu(), ref["rows"][0])
    del cache, logits
    counters = _serve_counters()
    _zeroed(counters)
    shape = dataclasses.replace(SHAPES["long_500k"], seq_len=max_seq)
    eng = FixedBatchEngine(model, lambda tp: params,
                           ServeConfig(batch_size=1, max_seq=max_seq,
                                       max_new_tokens=DP_DECODE_STEPS),
                           device=DEVICE, mesh=mesh, rules=rules_for_shape(cfg, shape, mesh))
    eng.submit(ref["prompt"][0].numpy())
    dist.barrier()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    return {"rank": rank, "coords": list(mesh.get_coordinate()),
            "rules": {a: rules.lookup(a) for a in
                      ("batch", "seq", "kv_seq", "ssm_state", "heads", "kv_heads",
                       "ssm_heads", "conv_dim")},
            "cache_shapes": cache_shapes, "prefill_s": prefill_s, "peak_gb": peak_gb,
            "whole_peak_gb": whole_peak_gb,
            "digest": digest, "errs": errs, "cache_errs": cache_errs, "tp_errs": tp_errs,
            "agree": agree,
            "compared": compared, "step_ms": step_ms, "stream": done[0].output,
            "engine_s": time.perf_counter() - t0, "engine_prefill_s": eng.stats["prefill_s"],
            "launches": _launched(counters)}


def dp_serve_child(torch, rank, world, store, out_path, job_path):
    """One rank of phase 25, run as `chip_smoke.py --dp-serve-child RANK
    WORLD STORE OUT JOB`: the MoE and qwen3 through FixedBatchEngine on the
    (data 2, model 2) mesh, each drawn from seed 0 straight into the
    rank's shards, then zamba2's and mamba2's sequence-parallel prefill
    (`_dp_seq_rank`, against the no-mesh runs whose files JOB names);
    writes streams, drops, launches, errors, memory and times to OUT as
    JSON."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_file_world, make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.mlp import record_drops
    from repro_torch.serve.engine import FixedBatchEngine, ServeConfig

    torch.cuda.set_device(0)
    torch.cuda.init()
    init_file_world(store, rank, world, "gloo")
    with open(job_path) as f:
        job = json.load(f)
    results = {}
    try:
        mesh = make_mesh(DP_MESH)
        for arch in DP_RULES:
            cfg = dp_cfg(arch)
            model = build_model(cfg)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device=DEVICE).manual_seed(0)
            t0 = time.perf_counter()
            eng = FixedBatchEngine(
                model, lambda tp: model.init_serving(gen, tp=tp),
                ServeConfig(batch_size=FIXED_BATCH, max_seq=DP_MAX_SEQ,
                            max_new_tokens=SERVE_RUNTIME["max_new_tokens"]),
                device=DEVICE, mesh=mesh, rules=dp_rules(cfg, mesh))
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            init_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with eng.serve_mesh.contexts():
                caches = model.init_cache(FIXED_BATCH, DP_MAX_SEQ, device="meta", tp=eng.tp)
            for p in dp_prompts(cfg):
                eng.submit(p)
            counters = _serve_counters()
            _zeroed(counters)
            dist.barrier()
            t0 = time.perf_counter()
            with record_drops() as drops:
                done = eng.run()
            torch.cuda.synchronize()
            results[arch] = {
                "rank": rank, "coords": list(mesh.get_coordinate()), "rows": list(eng.rows),
                "rules": {a: eng.rules.lookup(a) for a in
                          ("batch", "heads", "kv_heads", "kv_seq", "experts", "expert_ffn",
                           "ffn", "vocab")},
                "cache_shapes": {k: list(v.shape) for k, v in caches.items()},
                "cache_bytes": sum(v.numel() * v.element_size() for v in caches.values()),
                "streams": {str(r.rid): [int(t) for t in r.output] for r in done},
                "drops": [torch.nonzero(~k).flatten().tolist() for k in drops],
                "launches": _launched(counters),
                "param_gb": sum(t.numel() * t.element_size()
                                for t in _leaves(eng.params)) / 1e9,
                "leaf_gb": full_leaf_bytes(cfg) / 1e9,
                "init_s": init_s, "init_peak_gb": init_peak / 1e9,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "tokens_per_s": eng.throughput(), "prefill_s": eng.stats["prefill_s"],
                "wall_s": time.perf_counter() - t0,
            }
            del eng, done

        for arch, plen in DP_SEQ_PROMPTS.items():
            results[f"{arch} seq"] = _dp_seq_rank(torch, arch, plen, mesh, job[arch], rank)
        with open(out_path, "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()


def phase_dp_serving(torch, smi=""):
    """Phase 25 (see the module docstring); `smi`: the card's nvidia-smi
    line, logged beside the phase's numbers.  -> launches per path: each
    model's no-mesh run's and each rank's."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models.mlp import record_drops

    t_phase = time.perf_counter()
    counters = _serve_counters()
    paths, ref = {}, {}
    for arch in DP_RULES:
        cfg = dp_cfg(arch)
        model, params = family_setup(torch, cfg)
        prompts = dp_prompts(cfg)
        _zeroed(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with record_drops() as drops:
            out, _, tps, _ = fixed_serve(torch, model, params, prompts,
                                         f"{arch} no mesh", DP_MAX_SEQ, loop=True)
        caches = model.init_cache(FIXED_BATCH, DP_MAX_SEQ, device="meta")
        act_gb = (torch.cuda.max_memory_allocated() - held
                  - sum(v.numel() * v.element_size() for v in caches.values())) / 1e9
        drops = [torch.nonzero(~k).flatten().tolist() for k in drops]
        launches = _launched(counters)
        if set(launches) != {"sample_draw"}:
            raise AssertionError(f"[{arch}] launches {launches}: want the draw kernel only")
        log(f"[{arch} no mesh, {cfg.n_layers} layers] launches {launches}; "
            f"{sum(map(len, drops))} (token, choice) pairs dropped over {len(drops)} "
            f"decode calls; the run's transient beyond its caches {act_gb:.3f} GB")
        paths[f"dp_{arch}_no_mesh"] = launches
        ref[arch] = (model, params, prompts, out, drops, launches, act_gb)

    # the sequence-parallel prefill's references with no mesh: each model's
    # prefill (its logits, whole cache and peak beyond the parameters), then
    # DP_DECODE_STEPS greedy decode steps (each step's logits and token)
    tmp = tempfile.mkdtemp(prefix="dp_serve_")
    job, seq_ref = {}, {}
    for arch, plen in DP_SEQ_PROMPTS.items():
        cfg = dp_cfg(arch)
        model, params = family_setup(torch, cfg)
        max_seq = plen + DP_DECODE_STEPS
        rng = np.random.default_rng(1)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, plen)),
                               dtype=torch.int32, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        logits, cache = steps.prefill_step(model, params, toks, max_seq)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        whole = {k: v.to("cpu", copy=True) for k, v in cache.items()}   # before decoding
        rows, stream = [logits[0, -1].float().cpu()], []
        t0 = time.perf_counter()
        for _ in range(DP_DECODE_STEPS):
            stream.append(int(rows[-1].argmax()))
            logits, cache = steps.serve_step(model, params, cache, torch.tensor(
                [[stream[-1]]], dtype=torch.int32, device=DEVICE))
            rows.append(logits[0, -1].float().cpu())
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / DP_DECODE_STEPS
        log(f"[{arch} no mesh, {cfg.n_layers} layers] batch 1: prefill of {plen} tokens "
            f"into {max_seq} positions in {prefill_s:.3f} s, its peak beyond the parameters "
            f"{peak_gb:.3f} GB; {DP_DECODE_STEPS} decode steps at {step_ms:.2f} ms")
        job[arch] = os.path.join(tmp, f"{arch}.pt")
        torch.save({"prompt": toks.cpu(), "rows": torch.stack(rows), "stream": stream,
                    "cache": whole}, job[arch])
        seq_ref[arch] = (peak_gb, prefill_s, torch.stack(rows), stream)
        del model, params, cache, logits, whole
        free_device(torch)
    with open(os.path.join(tmp, "job.json"), "w") as f:
        json.dump(job, f)
    job = os.path.join(tmp, "job.json")

    build.build_all()                          # every library in place before spawning
    t0 = time.perf_counter()
    ranks = _tp_world(DP_WORLD, tmp, "--dp-serve-child", "dp", extra=(job,))
    log(f"[dp] the (data 2, model 2) world served {len(DP_RULES)} models and the "
        f"sequence-parallel prefill of {', '.join(DP_SEQ_PROMPTS)} in "
        f"{time.perf_counter() - t0:.1f} s (start included); "
        f"nvidia-smi: {smi}")
    for arch in DP_RULES:                      # every rank's numbers first
        for res in (r[arch] for r in ranks):
            log(f"[{arch} dp] rank {res['rank']} at {res['coords']} (rows {res['rows']}, "
                f"rules {res['rules']}, caches {res['cache_shapes']}): "
                f"{res['tokens_per_s']:.1f} tokens/s, prefill {res['prefill_s']:.3f} s, wall "
                f"{res['wall_s']:.2f} s, launches {res['launches']}; params "
                f"{res['param_gb']:.3f} GB drawn in {res['init_s']:.1f} s (peak "
                f"{res['init_peak_gb']:.2f} GB), caches {res['cache_bytes'] / 1e9:.3f} GB, "
                f"the run's peak {res['peak_gb']:.2f} GB; "
                f"{sum(map(len, res['drops']))} pairs dropped")
    for arch in DP_SEQ_PROMPTS:
        for res in (r[f"{arch} seq"] for r in ranks):
            log(f"[{arch} seq dp] rank {res['rank']} at {res['coords']} (rules "
                f"{res['rules']}, caches {res['cache_shapes']}): prefill "
                f"{res['prefill_s']:.3f} s, its peak beyond the rank's parameters "
                f"{res['peak_gb']:.3f} GB ({res['whole_peak_gb']:.3f} with the whole prompt "
                f"on every rank); max |logit difference| / max |logit| "
                f"{res['errs'][0]:.4f} at the prefill, {max(res['errs'][1:]):.4f} at most over "
                f"{DP_SEQ_CHECK_STEPS} decode steps ({res['step_ms']:.1f} ms a step; argmax equal "
                f"at {res['agree']}/{res['compared']} with a top-2 margin > "
                f"{FIRST_TOKEN_MARGIN}); cache errors "
                + ", ".join(f"{k} {v:.4f}" for k, v in res["cache_errs"].items())
                + " (with the whole prompt on every rank: "
                + ", ".join(f"{k} {v:.4f}" for k, v in res["tp_errs"].items())
                + f"); the engine in {res['engine_s']:.2f} s (prefill "
                f"{res['engine_prefill_s']:.3f} s), launches {res['launches']}")
    for arch in DP_RULES:
        model, params, prompts, out_ref, drops, launches, act_gb = ref[arch]
        res = [r[arch] for r in ranks]
        for r in res[1:]:
            if r["streams"] != res[0]["streams"]:
                raise AssertionError(f"[{arch} dp] rank {r['rank']}'s streams differ "
                                     "from rank 0's")
        for r in res:
            if r["launches"] != launches:
                raise AssertionError(f"[{arch} dp] rank {r['rank']}: launches "
                                     f"{r['launches']}, no mesh {launches}")
            if r["drops"] != drops:
                raise AssertionError(f"[{arch} dp] rank {r['rank']}: decode drops differ "
                                     "from the no-mesh engine's")
            paths[f"dp_{arch}_rank{r['rank']}"] = r["launches"]
        if arch == "qwen3-1.7b":
            # the run: shards + the reckoned cache + the no-mesh run's
            # transient; the draw: shards + one f32 full leaf and its f32
            # shard (what `init_serving(tp=)` holds at once, phase 22)
            want = dp_cache_reckoning(model.cfg)
            for r in res:
                allowed = r["param_gb"] + want / 1e9 + act_gb
                init_allowed = r["param_gb"] + r["leaf_gb"] * (1 + 1 / DP_MESH[1])
                if (r["cache_bytes"] != want or r["peak_gb"] > allowed
                        or r["init_peak_gb"] > init_allowed):
                    raise AssertionError(
                        f"[{arch} dp] rank {r['rank']}: cache {r['cache_bytes']} B "
                        f"(reckoned {want}), the run's peak {r['peak_gb']:.2f} GB against "
                        f"{allowed:.2f}, the draw's {r['init_peak_gb']:.2f} against "
                        f"{init_allowed:.2f}")
            log(f"[{arch} dp] every rank's cache {want:,} B as reckoned (rows "
                f"{FIXED_BATCH // DP_MESH[0]}, positions {DP_MAX_SEQ // DP_MESH[1]}, "
                f"{model.cfg.n_kv_heads} KV heads); the run's peak within shards + that "
                f"cache + the no-mesh transient {act_gb:.3f} GB, the draw's within shards "
                "+ one f32 full leaf and its f32 shard")
        out = {int(k): v for k, v in res[0]["streams"].items()}
        if sorted(out) != sorted(out_ref) or any(
                len(v) != SERVE_RUNTIME["max_new_tokens"] for v in out.values()):
            raise AssertionError(f"[{arch} dp] requests {sorted(out)} unfinished")
        same = sum(out[r] == out_ref[r] for r in out_ref)
        t0 = time.perf_counter()
        rows = teacher_forced_rows(torch, model, params, prompts, DP_MAX_SEQ, out)
        n_first, n_all = margin_agree(f"{arch} dp", rows, out, "the no-mesh replay")
        log(f"[{arch} dp] streams equal on every rank; {same}/{len(out_ref)} identical to "
            f"the no-mesh run's, first divergence {_first_divergence(out_ref, out)}; "
            f"decode drops equal the no-mesh engine's ({sum(map(len, drops))} pairs); "
            f"against the no-mesh loop teacher-forced ({time.perf_counter() - t0:.1f} s): "
            f"{n_all}/{len(rows)} tokens ({n_first} first tokens) had a top-2 margin > "
            f"{FIRST_TOKEN_MARGIN}, all agree")
        if n_all == 0:
            raise AssertionError(f"[{arch} dp] no token had a margin to compare")
        del model, params
        ref[arch] = None
    for arch, (peak_gb, prefill_s, rows, stream) in seq_ref.items():
        label = f"{arch} seq dp"
        res = [r[f"{arch} seq"] for r in ranks]
        for r in res:
            bad = {k: v for k, v in r["cache_errs"].items()
                   if v > max(DP_CACHE_TOL, DP_CACHE_TP_RATIO * r["tp_errs"][k])}
            if r["digest"] != res[0]["digest"] or r["stream"] != res[0]["stream"]:
                raise AssertionError(f"[{label}] rank {r['rank']}'s prefill logits or "
                                     "stream differ from rank 0's")
            if max(r["errs"]) > DP_BATCH1_TOL or bad or r["agree"] != r["compared"]:
                raise AssertionError(
                    f"[{label}] rank {r['rank']}: max logit error {max(r['errs']):.4f} "
                    f"(tolerance {DP_BATCH1_TOL}), cache errors over {DP_CACHE_TOL} and "
                    f"{DP_CACHE_TP_RATIO} x the whole-prompt run's: {bad}, "
                    f"margin tokens {r['agree']}/{r['compared']} agree")
            if r["peak_gb"] >= peak_gb:
                raise AssertionError(f"[{label}] rank {r['rank']}: prefill peak "
                                     f"{r['peak_gb']:.3f} GB, no mesh {peak_gb:.3f} GB")
            if r["launches"] != {"sample_draw": DP_DECODE_STEPS}:
                raise AssertionError(f"[{label}] rank {r['rank']}: launches {r['launches']}")
            paths[f"dp_{arch}_seq_rank{r['rank']}"] = r["launches"]
        div = next((j for j, (a, b) in enumerate(zip(res[0]["stream"], stream)) if a != b),
                   None)
        if div is not None:
            top2 = torch.topk(rows[div], 2)
            margin = float(top2.values[0] - top2.values[1])
            if margin > FIRST_TOKEN_MARGIN:
                raise AssertionError(f"[{label}] the engine's token {div} differs from the "
                                     f"no-mesh stream's at a top-2 margin {margin:.3f}")
        log(f"[{label}] prefill logits bitwise equal on every rank, the engine's streams "
            f"equal; logits within {DP_BATCH1_TOL} x max |logit| of the no-mesh run's at the "
            f"prefill and {DP_SEQ_CHECK_STEPS} decode steps, caches within {DP_CACHE_TOL} x max "
            f"of its cut or {DP_CACHE_TP_RATIO} x the whole-prompt run's error, "
            f"margin tokens agree; every rank's prefill peak below the no-mesh "
            f"{peak_gb:.3f} GB (largest {max(r['peak_gb'] for r in res):.3f} GB); the "
            f"engine's stream equal to the no-mesh stream "
            + ("throughout" if div is None else f"up to token {div} (margin {margin:.3f})")
            + f"; {DP_DECODE_STEPS} draw launches a rank")
    shutil.rmtree(tmp, ignore_errors=True)
    _phase_end("dp serving", t_phase)
    return paths


# ----------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the serving runs (kernel and torch lanes, "
                         "graphed and eager) and the ResNet-18 forwards with "
                         "torch.profiler and print the device busy share and "
                         "device time by kernel (no timing summaries)")
    ap.add_argument("--train-memory", action="store_true",
                    help="run one (data 2, model 1) rank's train step alone under the "
                         "allocator's history and print what is live at its peak "
                         "(no other phase, no result line)")
    ap.add_argument("--skip-serve", action="store_true",
                    help="stop after the kernel checks (no result line); "
                         "skips phases 3 to 26")
    ap.add_argument("--tp-child", nargs=4, metavar=("RANK", "WORLD", "STORE", "OUT"),
                    help=argparse.SUPPRESS)      # one rank of phase 21 (b)
    ap.add_argument("--tp-family-child", nargs=4,
                    metavar=("RANK", "WORLD", "STORE", "OUT"),
                    help=argparse.SUPPRESS)      # one rank of phase 22 (b)
    ap.add_argument("--tp-fixed-child", nargs=4,
                    metavar=("RANK", "WORLD", "STORE", "OUT"),
                    help=argparse.SUPPRESS)      # one rank of phase 23 (b)
    ap.add_argument("--train-tp-child", nargs=5,
                    metavar=("RANK", "WORLD", "STORE", "OUT", "JOB"),
                    help=argparse.SUPPRESS)      # one rank of phase 24
    ap.add_argument("--dp-serve-child", nargs=5,
                    metavar=("RANK", "WORLD", "STORE", "OUT", "JOB"),
                    help=argparse.SUPPRESS)      # one rank of phase 25
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import attention as KA
        from repro_torch.kernels import conv2d as KC
        from repro_torch.kernels import fused as KF
        from repro_torch.kernels import matmul as KM
        from repro_torch.kernels import sampling as KS
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products in cuBLAS accumulate in f32 and round once, as the
    # JAX reference's vendor lane and the GEMM kernel do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    for flag, child in ((args.tp_child, tp_child), (args.tp_family_child, tp_family_child),
                        (args.tp_fixed_child, tp_fixed_child),
                        (args.train_tp_child, train_tp_child),
                        (args.dp_serve_child, dp_serve_child)):
        if flag:
            rank, world, store, out, *more = flag
            child(torch, int(rank), int(world), store, out, *more)
            return 0

    if args.train_memory:
        log("nvidia-smi: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
        train_memory_history(torch)
        return 0

    t_phase = time.perf_counter()
    smi = phase_environment(torch)
    log(f"== phase 1 seconds: {time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()

    checks = [
        Check("paged_decode_attention", "src/repro_torch/kernels/csrc/paged_decode.cu",
              "src/repro/kernels/attention.py:365", KA.paged_decode_attention),
        Check("paged_prefill_attention", "src/repro_torch/kernels/csrc/paged_prefill.cu",
              "src/repro/kernels/attention.py:294", KA.paged_prefill_attention),
        Check("matmul_fused", "src/repro_torch/kernels/csrc/matmul.cu",
              "src/repro/kernels/matmul.py:57", KM.matmul_fused),
        Check("conv2d_direct", "src/repro_torch/kernels/csrc/conv2d.cu",
              "src/repro/kernels/conv2d.py:61", KC.conv2d_direct),
        Check("fused_elementwise", "src/repro_torch/kernels/csrc/fused_elementwise.cu",
              "src/repro/kernels/fused.py:40", KF.fused_elementwise),
        Check("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/attention.py:98", KA.flash_attention),
        Check("dense_decode_attention", "src/repro_torch/kernels/csrc/dense_decode.cu",
              "src/repro/kernels/attention.py:414", KA.dense_decode_attention),
        # no Pallas kernel: the reference's draw (XLA-fused) in _sample_row
        Check("sample_draw", "src/repro_torch/kernels/csrc/sampling.cu",
              "src/repro/kernels/sampling.py:80", KS.sample_draw),
    ]
    log("== kernels against their plain versions")
    check_decode(torch, checks[0])
    check_prefill(torch, checks[1], PREFILL_BLOCK_Q)
    check_matmul(torch, checks[2], get_config("qwen3-1.7b"))
    check_conv2d(torch, checks[3])
    check_fused(torch, checks[4])
    check_flash(torch, checks[5])
    check_dense_decode(torch, checks[6])
    check_counter_growth(torch, checks[6])
    check_sampling(torch, checks[7], get_config("qwen3-1.7b").vocab)
    check_matmul_ssm(torch, checks[2], get_config("mamba2-2.7b"))
    check_sampling(torch, checks[7], get_config("mamba2-2.7b").vocab, SSM_SAMPLE_SHAPES)
    check_matmul_models(torch, checks[2], get_config("granite-3-8b"),
                        get_config("qwen2-moe-a2.7b"))
    check_sampling(torch, checks[7], get_config("granite-3-8b").vocab)
    check_matmul_vlm(torch, checks[2], get_config("qwen2-vl-2b"))
    for arch in ("zamba2-1.2b", "whisper-base"):
        check_sampling(torch, checks[7], get_config(arch).vocab, FIXED_SAMPLE_SHAPES)
    check_matmul_large(torch, checks[2], get_config("internlm2-20b"),
                       get_config("starcoder2-15b"))
    for arch in ("internlm2-20b", "starcoder2-15b"):
        check_sampling(torch, checks[7], get_config(arch).vocab)
    check_tp_shapes(torch, checks, get_config("qwen3-1.7b"), PREFILL_BLOCK_Q)
    check_tp_family_shapes(torch, checks, PREFILL_BLOCK_Q)
    knob_paths = check_matmul_knobs(torch, checks[2], get_config("qwen3-1.7b"),
                                    get_config("mamba2-2.7b"))
    torch.cuda.synchronize()
    log(f"== phase 2 seconds: {time.perf_counter() - t_phase:.1f}")
    if args.skip_serve:
        log("--skip-serve: stopping after the kernel checks")
        return 3

    def timed_phase(n, title, fn, *a):
        log(f"== {title}")
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"== phase {n} seconds: {time.perf_counter() - t0:.1f}")
        return out

    served = serving_setup(torch, get_config("qwen3-1.7b"))
    serve_launches, torch_run, router, greedy_out, kernel_tps = timed_phase(
        3, "serving qwen3-1.7b through ContinuousEngine", phase_serve,
        torch, served, PREFILL_BLOCK_Q, args.profile)
    sampled_launches = timed_phase(
        6, "sampled serving: the mixed cycle through the step programs",
        phase_sampled, torch, served, router, greedy_out, args.profile)
    wpk, wpk_plan, wpk_fitness = timed_phase(
        4, "the paper's pipeline on ResNet-18 (optimize_graph, select, Engine)",
        phase_wpk, torch, args.profile)
    example_paths = timed_phase(
        26, "the port's examples: quickstart, tune_resnet18 (on phase 4's fitness) and "
        "serve_inference at their JAX sizes", phase_examples, torch, wpk_fitness)
    plan_paths, wall_plan, wall_tps = timed_phase(
        5, "the serve plan: build_serve_plan on the card, then serving under it",
        phase_serve_plan, torch, served, [c.fn for c in checks], torch_run, kernel_tps)
    fit_paths = timed_phase(
        10, "the analytic fitness against the card", phase_fitness, torch, served,
        [c.fn for c in checks], checks, torch_run, wall_plan, wall_tps, wpk_plan)
    ssm_paths = timed_phase(
        7, "serving mamba2-2.7b through ContinuousEngine (the slot-pooled state cache)",
        phase_ssm, torch, dataclasses.replace(get_config("mamba2-2.7b"),
                                              n_layers=SSM_SERVE_LAYERS), args.profile)
    del served
    free_device(torch)
    moe_paths = timed_phase(
        8, "serving qwen2-moe-a2.7b through ContinuousEngine (the MoE on the paged "
        "programs)", phase_moe, torch, dataclasses.replace(
            get_config("qwen2-moe-a2.7b"), n_layers=MOE_SERVE_LAYERS),
        [c.fn for c in checks], args.profile)
    free_device(torch)
    granite_paths = timed_phase(
        9, "serving granite-3-8b through ContinuousEngine (G = 4, vocab 49,155)",
        phase_decoder, torch, get_config("granite-3-8b"), "granite",
        "serve_granite_3_8b", args.profile)
    free_device(torch)
    vlm_paths = timed_phase(
        11, "serving qwen2-vl-2b (M-RoPE, G = 6) through ContinuousEngine, and with "
        "its vision embeddings through the fixed-batch loop", phase_vlm, torch,
        get_config("qwen2-vl-2b"), args.profile)
    free_device(torch)
    hybrid_paths = timed_phase(
        12, "serving zamba2-1.2b (HybridLM) through the fixed-batch loop",
        phase_fixed_family, torch, get_config("zamba2-1.2b"), HYBRID_FIXED_LENS,
        HYBRID_FIXED_SEQ, "zamba2", "fixed_zamba2_1_2b")
    free_device(torch)
    encdec_paths = timed_phase(
        13, "serving whisper-base (EncDecLM, 1500 audio frames) through the "
        "fixed-batch loop", phase_fixed_family, torch, get_config("whisper-base"),
        ENCDEC_FIXED_LENS, ENCDEC_FIXED_SEQ, "whisper", "fixed_whisper_base",
        "audio_embeds")
    free_device(torch)
    timed_phase(14, "training qwen3-1.7b at full width and depth through the port's "
                "train step", phase_train, torch, get_config("qwen3-1.7b"),
                [c.fn for c in checks], smi)
    free_device(torch)
    timed_phase(15, "the Trainer end to end (checkpoints, preemption, resume) and one "
                "train step of each other family", phase_train_loop, torch,
                [c.fn for c in checks])
    free_device(torch)
    long_paths = timed_phase(
        16, "long-KV attention: both forms at S 4096, a train step at 4096 tokens, "
        "a 32,768-token prefill", phase_long_kv, torch, [c.fn for c in checks])
    free_device(torch)
    internlm2_paths = timed_phase(
        17, "serving internlm2-20b through ContinuousEngine (48 layers, G = 6, "
        "vocab 92,544)", phase_decoder, torch, get_config("internlm2-20b"),
        "internlm2", "serve_internlm2_20b", args.profile, True)
    free_device(torch)
    starcoder2_paths = timed_phase(
        18, "serving starcoder2-15b through ContinuousEngine (40 layers, G = 12, "
        "d_ff 24,576)", phase_decoder, torch, get_config("starcoder2-15b"),
        "starcoder2", "serve_starcoder2_15b", args.profile, True)
    free_device(torch)
    timed_phase(19, "the mesh: single_device_mesh() and the sharding rules on the card",
                phase_mesh, torch)
    race_paths = timed_phase(
        20, "the layout race: qwen3-1.7b's serve plan with model_parallel 2 / 4 / 8 on "
        "device time", phase_layout_race, torch, [c.fn for c in checks])
    tp_paths = timed_phase(
        21, "tensor-parallel serving: tp_mesh(1) against no mesh, then tp = 2 / 4 as "
        "processes on the card", phase_tp_serving, torch, [c.fn for c in checks])
    free_device(torch)
    family_tp_paths = timed_phase(
        22, "tensor-parallel serving of qwen2-vl-2b, mamba2-2.7b and qwen2-moe-a2.7b: "
        "tp_mesh(1) against no mesh, then tp = 2 / 4 as processes on the card",
        phase_tp_families, torch, [c.fn for c in checks])
    free_device(torch)
    fixed_tp_paths = timed_phase(
        23, "the fixed-batch loop on a mesh: zamba2-1.2b and whisper-base through "
        "FixedBatchEngine, tp_mesh(1) against no mesh, then tp = 2 / 4 as processes on "
        "the card", phase_tp_fixed, torch)
    free_device(torch)
    timed_phase(24, "training on a mesh as processes on the card: qwen3-1.7b on (data 1, "
                "model 2) and (data 2, model 1) with ZeRO-1, on (pod 2, data 2, model 1), "
                "and zamba2-1.2b's 16,384-token sequence over data on (data 2, model 2), "
                "each against the no-mesh step; the elastic restart", phase_train_tp,
                torch, [c.fn for c in checks], smi)
    free_device(torch)
    dp_paths = timed_phase(
        25, "serving on a (data 2, model 2) mesh: qwen2-moe-a2.7b with TP inside the "
        "experts, qwen3-1.7b with the KV positions over model, the sequence-parallel "
        "prefill of zamba2-1.2b and mamba2-2.7b at 16k tokens, as processes on the card",
        phase_dp_serving, torch, smi)
    paths = {**knob_paths, **race_paths, **tp_paths, **family_tp_paths, **fixed_tp_paths,
             **dp_paths, **example_paths,
             "serve_qwen3_1_7b": serve_launches,
             "serve_sampled": sampled_launches, **wpk, **plan_paths, **fit_paths,
             **ssm_paths, **moe_paths, **granite_paths, **vlm_paths,
             **hybrid_paths, **encdec_paths, **long_paths, **internlm2_paths,
             **starcoder2_paths}
    kernels = [c.record({p: n[c.fn.__name__] for p, n in paths.items()
                         if c.fn.__name__ in n}) for c in checks]
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on a path: {missing}")
    print(json.dumps({"kernels": kernels}))
    print(smi)                       # the card's name and power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
