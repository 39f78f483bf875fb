#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports nothing of JAX or of the JAX package.  Phases, none of which
catches its own failure:

  1. the card: name, count, power limit;
  2. build every kernel from paddle_tpu_torch/csrc (one nvcc per source,
     started together) and print nvcc's -Xptxas -v report;
  3. each kernel at its main paths' shapes (transformer-base: d_model 512,
     8 heads of 64; serving in float32 at batch 8, training at batch 16
     in float32 and batch 128 in bfloat16, the Scheduler's paged decode
     over a 2560-block pool and its 2048-token causal prefill in float32
     and bfloat16) against its plain PyTorch version on the card
     (float32: max abs error <= 1e-4; bfloat16: 2e-2, of the output's
     largest magnitude for the backward; the flash forward's lse 1e-4),
     and the flash tier's forward (#3) and backward (#4 dQ, #5 dK/dV) at
     BERT-base pretraining's shapes (batch 16 x 2048 tokens and batch 8 x
     4096, 12 heads of 64, masked and unmasked, bfloat16 and float32) and
     at transformer widths (causal 2048, a causal Sq < Sk offset, an
     off-grid 1000 with a kv_len-0 row), and kernel #8 (batch-norm affine
     + relu folded into a 1x1 conv) at ResNet-50's four conv3 sites
     (batch 256, bfloat16: 2e-2 of the output's largest magnitude) and a
     float32 case, and last the bfloat16 backward at head_dim 128 (#2 at
     T2's shape with 4 heads of 128, #4 and #5 at L2's with 6), #7 at
     phase S's real lengths (1024-2080) in both dtypes and #6 in
     bfloat16, and #6 at the GRU translator's decode step (one head of
     256 over 24 keys, all live: batch 8, and 32 for beam 4, in both
     dtypes), and [15]'s BERT-base legs in bfloat16 (#1 and #2 at 512 x
     batch 64 and 1024 x batch 32, masked and unmasked; #3-#5 unmasked at
     1024 x batch 32 and 4096 x batch 8, #3 at 2048 x batch 16); one
     call of #6 or #7 must be exactly one launch of its
     kernel in a CUDA graph of that call (no merge, cast or scratch
     kernel, no copy);
     then timed with CUDA events, L2 flushed before every launch: kernel,
     plain version, and the library yardstick the port never calls
     (F.scaled_dot_product_attention with an equivalent mask, over a
     pre-gathered dense view for the paged kernel, and for the backward
     its autograd backward alone; for #8 a cuDNN 1x1 conv on the
     activation materialised beforehand, and the composite: the affine +
     relu materialised, then that conv), beside the least time the card could
     take (bytes over 3.35 TB/s, or FLOP over 67 TFLOP/s for float32 and
     989 TFLOP/s for bfloat16 inputs), and for bfloat16 the TFLOP/s on
     the device time (for #2 also what its kernels compute: S and dP
     three times over);
  4. serving: decode.Generator(...).generate, greedy, on
     transformer.base() with seeded random weights, in two phases
     (A: translation, 256-token sources and short prefixes; B: a long
     cache, 1024-token prefixes in a 2048-slot cache).  Each phase's
     kernel launch counts are set to 0 just before generate and read just
     after, and must equal what the gate predicts.  Then the same feeds
     through the composite tier (flash_attention "0"): prefill and
     teacher-forced step logits must agree within 1e-3.  Phase A's feeds
     then go through serving.Scheduler at its default paged_kv=False
     (host BlockPool, dense gather per step), counted the same way; every
     request's tokens must equal the sequential batch-1 Generator's.
     Phase Beam: generate(method="beam", beam_size=4) at phase A's feeds
     (8 sources, so the step runs at 32 rows): beam 1 must give greedy's
     tokens, beam 4's tokens and scores must equal the same search under
     Generator(mode="interpret") (scores within 1e-5), best beam first,
     and its launches the gate's prediction.  Every serving program of
     [4] and [5] runs through the Executor's jit path: eagerly at a
     signature's first call, captured as a CUDA graph at its second,
     replayed after; each phase prints the graphs it captured (and their
     seconds), replayed and warmed up, and its peak memory;
  5. serving through the Scheduler, phase S: paged_kv=True (the pool on
     the card, the rewritten step program) on transformer.base(), 2048-
     token prompt windows with ragged prompts of 1024-2048 tokens, a
     4096-slot cache, blocks of 16, 8 slots.  16 requests of 32 tokens:
     a second wave of 8 submitted after the first wave's 4th decode step
     and admitted while the first still decodes, one prompt repeated (a
     prefix-cache hit), one request evicted mid-flight (it replays).
     Launch counts are set to 0 before and read after and must equal the
     gate's prediction from the scheduler's own step and prefill counts;
     the profiles of phases B and S give #6's and #7's card ms per step
     and share of the busy time; before the counted run, uncounted
     traffic of the same shapes on other prompts captures its programs,
     and after it the captured step at one signature is held against an
     eager replay of its ops on the same feed (logits within 1e-5, equal
     launch counts);
     every request's tokens must equal the sequential Generator's; the
     pool must drain to 0 blocks; tokens/s, TTFT, ms per decode step and
     a profile of a few steps are printed.  Then, on the same weights,
     blocks of 16, 8 slots and S's request feeds (each phase its own
     seed):
     V, speculative decoding (build_decode(verify_len=4), spec_k 4, 8
     requests of 32 tokens, prompts of 1024-2048, a prefix hit, an
     eviction after the 2nd round), in two legs: V/trunc, the draft is
     build_draft(tier="trunc") (3 decoder layers on the target's
     scope); V/self, the draft is the target's own configuration, so
     every proposal must be accepted.  Reported: rounds, proposals,
     acceptance, tokens per row and round, host ms per round, and, from a
     profile of 4 rounds, card busy per round split into the draft steps
     and the verify window (a replayed graph runs no Python, so a range
     around a function inside a captured program would see nothing);
     C, chunked prefill (build_decode(chunk_len=512), prefill_chunk 512):
     after uncounted warm-up traffic of the same shapes, 4 prompts of
     256-512 tokens prefill whole and decode; after their 2nd step 4 of
     1024-2048 arrive and run 512-row windows, one per iteration after the
     decode step; one of them is exported after its first window and
     imported into a second Scheduler.  Reported: chunk passes and ms per
     pass, the gaps between decode steps, TTFT, and card busy per pass;
     then the C10 line: C's longest decode gap against S's longest
     monolithic prefill iteration, in the same run;
     H, the two-tier handoff: a prefill tier (prefill_chunk 512, blocks of
     16) runs 4 prompts with prefill_only=True and a decode tier with
     blocks of 32 resumes each from its record (kv_payload,
     recorded_tokens).  Reported: payload bytes, export and adoption ms.
     Each of V, C and H asserts the launch counts the gate predicts from
     the schedulers' counters, tokens equal to the sequential
     Generator's, and a drained pool;
  6. training: transformer.build + Adam(1e-4) through Executor.run on
     transformer.base() (seq 256, random tokens from a seed), on the
     default (jit) path: each training step after its signature's eager
     warm-up is one captured CUDA graph, its parameters and moments
     donated (written in place), and after a phase every graph must bind
     every argument but the feeds (none copied in at a call).  T1,
     float32, dropout 0, batch 16, ragged source lengths 128-256: 4
     steps with the launch counts set to 0 before and 18 forward and 18
     backward mha_block launches a step after; the same 4 steps from the
     same weights through the composite must give the same losses (rtol
     1e-4); then 4 steps each run twice from the same persistables and
     run counter, by the interpreter (mode="interpret") and by the
     captured graph, losses within rtol 1e-5.  T2, bench.py's
     transformer configuration (dropout 0, batch 128, bf16 AMP, Adam
     multi_precision): 2 warm-up (eager, capture) and 5 timed replays,
     tokens/s, ms per step, card busy time and idle share (profiled, and
     1 - card / host), #1's and #2's card time and share of it, graphs,
     capture seconds, graph-pool MiB, peak memory and MFU; its first loss
     must match the composite's within 2e-2.  T2/drop, T2's step at the
     published dropout 0.1 (44 dropouts a step): the warm-up and the
     capture each equal the interpreter's step from the same state and
     counter (rtol 1e-5), the same numbers as T2; every step fetches the
     first dropout's mask: the last two (two consecutive replays) differ
     and 0.9 +- 0.001 of each is kept;
  7. BERT-base masked-LM pretraining at 2048 tokens through
     bert.build + Adam(1e-4) + Executor.run on the jit path (dropout 0,
     random tokens and ragged input masks of 1024-2048 real tokens from a
     seed): every attention takes the flash tier, forward (#3) and grad
     (#3 again to recompute out and lse, then #4 and #5).  L1, float32,
     batch 2: 3 steps with the launch counts set to 0 before and exactly
     24 #3, 12 #4 and 12 #5 launches a step after; the same steps from
     the same weights through the composite give the same losses (rtol
     1e-4); 3 steps jit vs interpret as T1.  L2, bench.py's
     long_2048_masked leg (batch 16, bf16 AMP, Adam multi_precision): 2
     warm-up, 3 timed and 1 profiled step, T2's numbers and the flash
     kernels' card time and share; its first loss must match the
     composite's within 2e-2;
  8. ResNet-50 training through resnet.build(dataset="imagenet",
     fused_loss=True) + Momentum + Executor.run on the jit path (224x224
     images, 1000 classes, images and labels drawn as bench.py draws
     them).  R1, float32, batch 8, Momentum(1e-5, 0.9): 3 steps on the
     card and the same 3 on the port's CPU path from the same weights,
     losses within rtol 1e-3, every forward conv of the steps that ran
     their ops (warm-ups, captures) with cuDNN's TF32 off; 3 steps jit vs
     interpret as T1.  R2, bench.py's resnet50 step (batch 256, bf16
     AMP, Momentum(0.1, 0.9, multi_precision=True)): 2 warm-up, 3 timed
     and 1 profiled step, img/s, MFU and T2's numbers, the top kernels;
     its first loss within 2e-2 of a float32 forward of the same weights
     and batch; no kernel of the port runs in it.  R/probe: kernel #8 at
     the 16 conv3 sites of one more R2 step (conv2's output, the BN's
     saved statistics and affine, conv3's filter) against the port's own
     batch_norm + relu + conv2d, exactly 16 launches; then the conv1x1
     probe (paddle_tpu_torch.tools.conv1x1_fuse_probe) at its four
     shapes;
  9. image training: bench.py's five image legs (bench.py:497-553),
     each built as its _setup builds it (bf16 AMP, Momentum(0.01, 0.9,
     multi_precision=True), random_seed 1) and fed from RandomState(0),
     on the jit path: G (googlenet.build(), with its aux heads, batch
     128, 3x224x224, 1000 classes), AN (alexnet.build(), batch 256,
     3x224x224, 1000 classes), V16 (vgg.build(image_shape=(3, 32, 32),
     class_dim=10), batch 128), MN (mnist.build_conv(), batch 256,
     1x28x28, 10 classes) and SE (se_resnext.build(), batch 128,
     3x224x224: grouped 3x3 convs of 32 groups, sigmoid gates).  Each: 2
     warm-up, 5 timed and 1 profiled step, img/s (G's and AN's published
     K40m rates beside), T2's numbers and the card's time by kernel
     class, finite losses, every argument but the feeds bound, no port
     kernel, then the float32 clone(for_test=True) forward at batch 8
     (SE 4) on the card within rtol 1e-3 of the port's CPU path, the
     loss and the logits, and its lap; then B/book, the book's main
     programs (tests/book/_programs: fit_a_line, recognize_digits_mlp,
     word2vec, their grad and optimizer ops as the JAX package dumped
     them) from the port's own startup: 3 steps at batch 64 on the card
     (captured at the second) within rtol 1e-4 of the same steps on the
     port's CPU path, no port kernel;
 10. the recurrent family on the jit path, at bench.py's widths.  SL1
     (stacked_lstm.build(seq_len=100, hidden_dim=512, stacked_num=2),
     dict 30000, emb 512, float32, batch 4) and MT1
     (machine_translation.build: src and trg 24, dict 10000, emb and
     hidden 256, float32, batch 8): 3 Adam(1e-3) steps on the card and
     the same steps on the port's CPU path from the same weights, losses
     within rtol 1e-3 (TF32 off), then each step run by the interpreter
     and by the graph from the same state (rtol 1e-5); MT1 prints its
     attention tiers (the composite: 576 scores are below
     attn_flash_min_scores).  SL2 and MT2, bench.py's stacked_lstm
     (bench.py:554-605: batch 64, the 8-batch cycling feed) and
     machine_translation (bench.py:816-853: batch 128) legs, bf16 AMP,
     Adam(1e-3, multi_precision), random_seed 1: 2 warm-up, 5 timed and
     1 profiled step, T2's numbers in examples/s, the first loss within
     2e-2 of a float32 forward of the same weights and batch, no port
     kernel; for SL2 the LSTM loops' card time in one interpreted step
     (forward, the grad's replay, backward) and the reference's K40m
     figure on its own line.  MT/decode: build_decode at MT1's widths
     over MT1's trained weights in a fresh scope, 8 source rows: the
     teacher-forced steps within 2e-4 of the train program's logits;
     greedy (32 tokens) equal to mode="interpret", beam 1 equal to
     greedy, beam 4 on the captured step equal to mode="interpret"
     (scores within 1e-5); one #6 launch a step (one head of 256 over 24
     keys), counted; tokens/s, host and card ms a step;
 11. serving a saved model, phase I, float32 on the jit path.  I/infer,
     bench.py's infer leg (bench.py:671-813) for resnet.build(dataset=
     "imagenet"), googlenet.build(), alexnet.build() and vgg.build(depth=
     19) at 3x224x224, random_seed 1: each model's startup on the card,
     save_inference_model of its main prediction, then clone(for_test=
     True), InferenceTranspiler().transpile (the conv+bn fold, conv+relu,
     fc fuse, dropout strip) and _prune; batch 16 from RandomState(0): 2
     warm-up, 20 timed and 1 profiled forward, img/s, ms per batch, card
     ms, idle share (profiled and 1 - card / host), peak memory, graphs and
     the top 5 kernels; the same forward without the transpiler (card ms,
     top kernels); checks, each max printed: (a) the transpiled logits
     (the fc output that feeds the softmax) within 1e-4 of the
     untranspiled ones' largest magnitude, (b) a Predictor on the card
     over the saved directory within 1e-6 relative of (a)'s transpiled
     output, (c) the same directory in a Predictor on the CPU at batch 2
     within 1e-3 of the card's, (d) for ResNet-50, 4 clones of its
     Predictor in 4 threads, 3 runs each (warm-up, capture and replay
     while the others run), equal to the sequential run (rtol 1e-6, atol
     1e-7), then a round of replays timed beside one predictor; no port
     kernel runs; the reference's published 2S Xeon 6148 rates on their
     own line, as a CPU reference.  I/gen: transformer-base's training
     program (seq 256, source lengths) saved from a seeded startup as an
     inference model of its logits, loaded into a Predictor on the card,
     Predictor.generate of 32 greedy tokens at phase B's shape (batch 8,
     prefixes of 512-1024, a 2048-slot cache): tokens equal a
     decode.Generator's over the saving scope, #1 and #6 launched as the
     gate predicts (counted), and a later generate on the same spec reuses
     the cached Generator and captures no graph; tokens/s, prefill ms and
     host ms per step;
 12. the serving front end (serving.serve, ServingClient, telemetry,
     overload control) on transformer-base, float32, captured, weights
     from a seeded startup.  F/rpc: serve(..., paged_kv=True) at phase
     S's shapes on 127.0.0.1 port 0, telemetry on, admission off; every
     bucket's signatures warmed on the loop thread, then 16 requests of
     32 tokens from 8 client threads, each with its own ServingClient,
     streaming through on_token: tokens equal the sequential Generator's,
     #1, #3 and #7 launched as the gate predicts from the scheduler's
     counters (counted), one stitched trace a request (the client's
     channel attempt -> "serving.submit" -> "serving.request"), STATUS's
     registry snapshot counts the submits, PING and STATS answer, an
     expired SUBMIT is refused before the Scheduler counts it, DRAIN
     refuses and undrain serves, a client gone after 2 tokens cancels its
     request, QUIESCE finds 0 blocks in use, and every eager warm-up and
     capture ran on the Scheduler's loop thread; tokens/s, TTFT p50/p99
     by the client's clock and by serving.ttft_ms, host ms per decode
     step beside phase S's from the same run; then the same traffic on
     other prompts with telemetry off, through the wire and in process
     (8 threads submitting and iterating stream()), each counted and
     checked alike: their host ms per decode step tell the instruments'
     cost from the wire's.  F/tax, bench.py's
     telemetry tax (bench.py:1141-1174) at this width and bench.py's
     traffic (8 streams, 32-token sources, 8-token prompts, 24 new
     tokens, a 96-slot cache, the host pool): 10 interleaved pairs of
     continuous rounds, telemetry off and on, medians, quartiles and the
     overhead, of the medians and pair by pair.
     F/sweep, bench.py's Poisson open-loop sweep (bench.py:1176-1275) on
     that Scheduler: 0.5, 1, 2 and 4 times the sequential tier's capacity,
     40 requests a rate, 25% shared prompts, SLO = streams x the
     sequential latency: p50/p99 a rate, QPS at SLO, the queue depth's
     p99 and the prefix hit rate from the registry.  F/overload,
     bench.py's overload A/B (bench.py:1729-1930) at this width (16-token
     sources, 4-token prompts, 12 new tokens, a 48-slot cache, 6 slots, 96
     blocks of 8, 64 prompts): capacity measured after the estimators are
     reset and settled, SLO 3 x the calm estimate (250-10,000 ms), then
     5-second open-loop Poisson bursts at 1, 2, 4 and 8 times capacity,
     half interactive (deadline = the SLO), half batch, with the admission
     gate and brownout ON and OFF: goodput at SLO a leg, rejects,
     expiries and clamps; every accepted request's tokens are a prefix of
     the sequential Generator's (all of them when done unclamped), no
     interactive request done short.  Every served request of F/tax and
     F/sweep equals the sequential Generator's too.  These legs launch #6
     (the host pool's dense cache and the source) and #7 (the device
     pool's sweep), never #1 (mha_decode takes multiples of 128 keys; the
     32- and 16-key prefill windows take the composite): each leg's
     launches are zeroed before it, read after it and held against the
     prediction from its scheduler's decode steps, and [3] holds both
     kernels at these shapes;
 13. the serving fleet (fleet.FleetRouter, the ChaosProxy, replica
     processes, RollingDeploy) on transformer-base, float32, captured,
     every replica's weights from its own startup on the card, at
     fleet/replica.py's shapes (8-token sources, 3-token prompts, a
     28-slot cache, 4 slots, 40 blocks of 4, the host pool).
     F/fleet/inproc: three in-process replicas (a Scheduler and a
     ServingServer each, private scopes, every bucket warmed) behind a
     router, tests/test_fleet.py's traffic (4 prompt groups x 4 rounds, 8
     new tokens): the prefix hit rate pooled across them at least 0.9 x a
     single replica's on the same traffic; a replica whose loop is stopped
     with 3 requests queued, behind a ChaosProxy delaying every chunk 0.1
     s, spills an affine request to the idle one; a stream the proxy drops
     after 2 tokens is resubmitted under its request id, bitwise, each
     token delivered once; #6 counted as in [12] from the four
     schedulers' decode steps.  F/fleet: bench.py's fleet leg
     (bench.py:1946-2228) over `python -m paddle_tpu_torch.fleet.replica`
     processes ({"model": "base"}), each pinned to one of
     partition_cpus(4)'s cpusets and warmed over the wire before a router
     sees it: weak scaling at 1, 2 and 4 replicas (closed loop, 2 clients
     a replica, FL_PER_CLIENT requests each, 10 new tokens off an
     8-prompt pool; QPS, p50, p99, QPS at an SLO of 4 x the 1-replica
     p99; each replica's loadavg from PING and card MiB from nvidia-smi),
     a rolling v1 -> v2 deploy under load (zero requests dropped, MTTR,
     forced moves, each cutover split into process start, warm-up over
     the wire and readmission), and a kill -9 of replica 0 after the 2nd
     token of a stream affine to it (recovered_in_s, ejections,
     resubmits); every child is killed in a finally block.  F/disagg:
     bench.py's disagg A/B (bench.py:2231-2490) at transformer-base
     width on the device pool (16-token sources, prompts of 24 or 4 in a
     24-token window, 12 new tokens, a 48-slot cache, 6 slots, blocks of
     16): one Poisson schedule at 60% of the monolithic capacity through
     monolithic prefill, chunked prefill at 4, 8 and 16, and a prefill-
     only Scheduler handing KV to a decode one: the decode pass p99 and
     long-prompt TTFT p99 of each; then the two-tier fleet over the wire
     (a prefill replica behind a ChaosProxy, two decode replicas with
     blocks of 32, prefill_min_tokens the window): the prefill replica
     killed halfway raises prefill_fallbacks.  #6 and #7 counted from the
     schedulers' decode steps.  Every token of every leg equals the
     sequential Generator's;
 14. the int8 tier and the optimizer tail.  Q/ops: quantized_matmul at
     transformer-base's decode shapes (8 rows x 512->512, ->2048,
     2048->512, 512->32000) and a 2048-row prefill, quantized_conv2d at
     batch 16 on ResNet-50's conv1, a 3x3 64->64 at 56, a 1x1 1024->256 at
     14 and VGG-19's 3x3 64->64 at 224, each op on the card (its int8
     product through torch._int_mm, cuBLASLt's int8 tensor-core path)
     against the same op with the product in float64: the int32
     accumulators equal and the outputs bitwise; timed with CUDA events,
     L2 flushed, beside the plain version, the float32 library call on
     the dequantized values and the bound (2MNK over 1979 TOP/s, or the
     bytes over 3.35 TB/s).  I/int8: bench.py's int8 infer rows
     (bench.py:608-667) for ResNet-50 and VGG-19 at [11]'s batch and 20
     batches: the float predictions first, then QuantizeTranspiler ->
     freeze_int8(as_int8=True) -> convert_to_int8, img/s, the speedup,
     top-1 agreement, card ms, persistable bytes, the _int_mm calls
     counted against the program's; the int8 model saved and served by a
     Predictor on the card (bitwise the in-process program) and on the
     CPU at batch 2 (the same top-1, logits within 1e-2 of the largest).
     S/int8: bench.py's serving_int8 leg (bench.py:1611-1725) at
     transformer-base width and its traffic (8 streams, 32-token sources,
     8-token prompts, 24 new tokens, a 96-slot cache, the host pool):
     float and int8 tokens/s, agreement with the float tier,
     self-agreement with a sequential int8 Generator (at least 0.5), card
     ms a decode step of each, #6 and the _int_mm calls counted against
     the prediction.  V/int8: phase V with build_draft(tier="int8") as
     the draft on a freshly seeded scope: every token the sequential
     float Generator's, #1, #3 and #7 as the gate predicts, acceptance and
     the draft's card ms beside V/trunc's.  Q/qat: MNIST's conv net
     through training_transpile(range_abs_max), 3 captured steps on the
     card against the port's CPU path (rtol 1e-3; the range state's Iter
     3 and scale moved on both), jit = interpret, then freeze_int8 +
     convert_to_int8, saved and served by a Predictor on the card: top-1
     agreement with the float test program.  O/tail: each optimizer of
     the tail (LarsMomentum, Adagrad, Adamax, DecayedAdagrad, Adadelta,
     RMSProp, Ftrl, ProximalGD, ProximalAdagrad, ModelAverage) on that
     net, card vs CPU and jit vs interpret; ModelAverage's apply and
     restore give the live parameters back bitwise;
 15. BERT-base pretraining as bench.py runs it (bench.py:293-447), bf16
     AMP with Adam(1e-4, multi_precision), dropout 0, on the jit path.
     B/head: its seven legs, the headline (S 512, batch 64), masked (the
     same with ragged input masks), long_seq (1024, 32), long_seq_flash
     (the same with the flash_attention flag "flash", restored after),
     long_2048 (16), long_4096 and long_4096_masked (8): 2 warm-up and 3
     timed steps each, tokens/s, ms a step, MFU (bench.py's
     _bert_flops_per_token, copied), peak memory and graph pool, the
     tier the gate picks and launch counts equal to its prediction
     (mha_block: #1 and #2 once an attention a step; flash: #3 twice, #4
     and #5 once), the first loss within 2e-2 of a forward-only
     composite pass of the program's for_test clone (a composite
     training step at 4096 would keep 12 layers of [8, 12, 4096, 4096]
     float32 scores), and the first step's attention outputs of the
     first and the last layer within 2e-2 of the composite pass's
     largest.  B/mem: T2's step and the BERT headline's run plain, with
     fused_head=True and with RecomputeOptimizer over the model's
     checkpoints, from the plain run's weights: rate, peak memory and
     what each option saves, the last loss (after 4 updates) within 1e-3
     of plain's; then transformer-base at T1's batch and the BERT
     headline at batch 8 in float32, 3 steps each: remat = plain within
     1e-5, fused = unfused within 1e-4.  O/clip: MNIST's
     conv net at batch 64 with GradientClipByGlobalNorm(1.0), L1Decay and
     Adam over noam_decay and over piecewise_decay: 3 captured steps card
     vs CPU within 1e-5, the rate fetched after each replay the
     schedule's at that step, then 3 more steps jit = interpret exactly,
     the step counter 6;
 16. the sparse tier and the checkpoint manager, no kernel launched
     (host-side tables by the reference's design, the dense tower on the
     card).  CTR: bench.py's ctr_deepfm leg (bench.py:2493-2569; batch
     4096, 26 fields over 10^5 ids, embedding 10, MLP 400-400-400,
     Adam(1e-3), two services of 2 adagrad shards) through
     SparseTrainStep on the jit path: 3 steps against the port's CPU path
     from the same persistables and fresh services (losses rtol 1e-4; the
     touched rows within 1e-5, but for those of an example whose ReLU
     pattern differs between the two, at most 4 a step), one step by the
     interpreter and the graph (equal), then 20 timed steps with `run`
     and 20 with `run_pipelined` (examples/s, the host split of a step
     into prefetch, Executor.run and push; every push applied at the
     barrier, 2 x 20 counted), 2 profiled (card busy, idle share), one
     graph.  CTR/resume: 6 steps with a CheckpointManager save after
     step 3, steps 4-6 again after a restore into a fresh scope and fresh
     services: losses and tables bitwise.  CTR/remote: the embeddings
     over 2 `python -m paddle_tpu_torch.sparse.server` processes under a
     ShardSupervisor (bench.py's recovery protocol, bench.py:2572), a
     shard checkpoint before step 5 and kill -9 of shard 1 before step 7,
     12 steps: no exception, losses and tables bitwise an uninterrupted
     in-process run on the card; the MTTRs and a server's start seconds;
     the servers hold no CUDA context (nvidia-smi lists no more compute
     processes, the card's used memory grows < 64 MiB).  SP/reshard:
     bench.py's reshard leg (bench.py:2837) on the port's servers,
     prefetch/push examples/s at 1, 2, 4 and 8 servers and a live 2 -> 4
     reshard under load (worst step stall), the table after it bitwise
     its in-process mirror's.  CK/resnet: bench.py's ckpt leg
     (bench.py:2987), ResNet-50 float32 batch 8: sync save, async submit
     and total, restore ms, state bytes; the pruned forward's loss after
     the restore equal to the loss before;
 17. the dense op tails, no kernel launched.  X/ops: every op type of
     the slice (tensor, math, loss, misc, nn and 3-D groups, each one
     program with its backward) at a ResNet stage's image shape (batch 32,
     64 channels, 56x56: conv2d_transpose stride 2 to 112x112, group_norm
     with 32 groups, bilinear_interp up and down), 16^3 volumes and
     [256, 1024] rows: the card's captured replay against the port's CPU
     path (max abs error <= 1e-4 of max(1, the largest value); integer
     and bool outputs equal) and against the card's interpreter (equal),
     ms a replay per group; the random ops by their moments (jit =
     interpret); range, linspace and where on the host between captured
     segments.  X/attn: models/fluid_encoder.base() (6 layers at
     transformer-base width from nets.scaled_dot_product_attention and
     nets.glu, sequence 256, float32, Adam): 3 steps at batch 8 card vs
     CPU (losses rtol 1e-4, argmax equal), 3 steps jit = interpret, then
     10 captured steps at batch 64 (tokens/s, ms a step, idle share, peak
     memory).  X/metrics: layers.auc over 20 batches of 4096 (int64 stats
     = the CPU path's, AUC = metrics.Auc within 1e-6), chunk_eval under
     IOB and IOBES and precision_recall against the CPU path and
     metrics.py;
 18. control flow and the sequence family.  CF/mt: the book's machine
     translation chapter (an LSTM encoder, a DynamicRNN decoder: one
     static_rnn in the captured step; Adagrad with L2 decay) at bench.py's
     machine_translation widths (dict 10,000, word dim and hidden 256, T
     24, batch 128, float32): 3 steps card vs CPU (losses rtol 1e-3), 3
     steps jit = interpret bitwise, 5 timed steps (examples/s) and 2
     profiled (card busy, idle share); save_persistables, then the
     chapter's BeamSearchDecoder program loads them and decodes batch 16
     at beam 4 over 24 steps, captured (beam tokens/s): every beam
     re-scored by a float64 forward within 1e-4 of max(1, |score|), ids
     equal to the port's CPU decode on every row whose step margins all
     exceed 1e-4.  CF/beam_lm: tests/test_decode.py's cached-attention LM
     (kv_cache_append + fused_attention in the decoder block) at d 512, 8
     heads of 64, vocab 32,000, batch 8, beam 4, 32 steps: the gate picks
     flash_decode (#6), one launch a step inside the captured beam body;
     captured = interpret, beams re-scored.  CF/while: a While-with-
     parameter training step (16 trips of tanh(acc @ w) at [1024, 512] x
     [512, 512] and its grad), bounded (captured, its 16 trips unrolled) and
     unbounded (an eager segment, counted), card = CPU within 1e-5, jit =
     interpret bitwise, ms a trip; the book's while_loop program; IfElse
     over a NaN branch; a conditional_block by hand, on and off (off:
     its gather out of range and its sqrt of a negative).
     SEQ/ops: the 15 sequence ops of the slice at [64, 128, 256], forward
     and grad, card vs CPU within 1e-4 of max(1, the largest), integers
     equal, jit = interpret;
 19. the recurrent tail and the sequence losses, no kernel launched.
     SRL/train: the reference label-semantic-roles chapter (eight
     embedded feature slots, the word table `emb` fixed and seeded,
     Fluid's dynamic_lstm as fc + the raw `lstm` op with SeqLen and
     peepholes, depth 8 alternating, hidden_dim 512, a 59-wide emission,
     linear_chain_crf with crfw at learning rate 1e-3, SGD 0.01) at
     conll05's dictionaries (44,068 words, 3,162 predicates), batch 10,
     lengths 4-29 padded to 30: one captured graph a step, no eager
     segment; 3 steps card vs CPU (losses rtol 1e-3), 3 jit = interpret
     bitwise, 10 timed (examples/s, live tokens/s), 2 profiled (card
     busy, idle share), peak memory.  SRL/decode: crf_decoding with the
     trained weights, captured, its ids equal to the CPU's and to a
     float64 Viterbi on every row whose step margins exceed 1e-4; the
     decode graph saved and served by a Predictor on the card, its paths
     the in-process decode's.  RNN/fuse: the InferenceTranspiler's four
     RNN fusions (fc -> lstm, fc -> gru, sequence_conv + bias + relu, the
     attention-LSTM static_rnn) at those widths: output unchanged within
     1e-5 of max(1, |x|), the op types the JAX package leaves (recorded
     on the CPU, RF_JAX_TYPES), ms a replay before and after.  SEQ/tail:
     the slice's 17 op types in groups, forward and grads, card vs CPU
     within 1e-4 of max(1, the largest), integers equal, jit = interpret
     bitwise, ms a replay; nce's negatives by their mean and class-0
     share (5 standard errors), its cost and grads the CPU's pricing of
     the card's samples;
 20. the mixture-of-experts tier (gating, dispatch and the combine are
     plain PyTorch captured with the step; the expert products are
     torch.bmm; attention keeps the gate's kernels).  MoE/bench:
     bench.py's moe leg (bench.py:1451-1621: d_model 128, 2 layers, 8
     heads, 4 experts, top 2, capacity factor 1.25, vocab 4,000, batch 32
     x seq 64, float32, Adam(1e-4)): the MoE model and its dense twin at
     the same FFN FLOPs a token, 2 warm-up and 20 timed steps each
     (tokens/s = batch x seq x 2 x steps / wall, final losses, the gap),
     moe_drop_rate and the load imbalance from one eager step fetching
     every gating op's Load and Dropped; 3 steps card vs the port's CPU
     path (losses rtol 1e-3; at step 1 the share of (token, slot)
     assignments routed to another expert, each of the first op's
     witnessed by a probability gap within twice that op's card-vs-CPU
     spread), 3 steps jit = interpret bitwise; then tiny_moe(vocab=200)
     decode (16-token sources, 4-token prompts, 48-slot cache, 16 new
     tokens, 4 streams) through the Scheduler: tokens equal sequential
     generate(), every step observed by the load monitor, nothing
     dropped, load_signal().  MoE/ckpt: its training with a
     CheckpointManager save after step 3 of 6 (moe= the 4-shard
     placements, rebalanced to epoch 1), restored into a fresh scope:
     steps 4-6 bitwise, the placements adopted, tools/ckpt_fsck.py run
     by path passes.  MoE/base: transformer-base with every FFN 8
     experts of 2048 (top 2, capacity factor 1.25, aux weight 0.01) at
     T2's settings: 2 warm-up, 5 timed and 2 profiled steps, tokens/s and
     ms a step beside T2's, MFU by the dense twin's FLOPs (d_inner 4096;
     the router's 2 d E a token left out), peak memory and graph pool,
     launches as the gate predicts, the exact drop rate from the fetched
     Positions (Load and Dropped are bfloat16), the first loss within
     2e-2 of a float32 forward, one step by the interpreter twice (grads
     of the expert and router weights bitwise equal, the second under
     labelled profiler ranges: the card's ms in attention, gating,
     expert products and dispatch/combine) and its loss equal to the
     captured replay's.  MoE/serve: its decode (capacity factor 0) at
     [12] F/tax's shapes, 8 requests of 24 tokens through the Scheduler
     on the host pool and on the device pool: tokens equal the
     sequential Generator's, every step observed, 0 dropped, #6/#7 as
     the gate predicts;
 21. multi-device training (parallel/: DeviceMesh, the sharding and ZeRO
     passes, the ParallelExecutor's mesh mode on DTensor, ring
     attention): a 4-rank world (one process a rank, gloo: NCCL refuses
     two ranks on one card) trains transformer-base at the dryrun's
     config (__graft_entry__.py:43-45: vocab 8,000, 6 layers, 8 heads of
     64, d_inner 2048), 3 float32 Adam steps a leg, TF32 off, each rank
     feeding its own rows, against the port's single-process run on the
     card from the same weights (a checksum over every parameter) and
     batches: M/dp_tp (dp 2 x tp 2, ReduceStrategy.Reduce, tp_rules(),
     16 x 256 tokens, rtol 2e-4; #1/#2 on each rank's 4 local heads),
     M/ring (sp 4, 4 x 1024 tokens, rtol 3e-4; #3 on every ring rotation,
     #4/#5 in its backward), M/zero1 (dp 2 x tp 2, tp_rules(), ZeRO-1:
     a rank's optimizer-state bytes at most 0.55x the single process's);
     M/ring/check: ring_attention at sp 4 (2 x 1024, 8 heads of 64,
     causal, key lengths 700 and 1024) against #3's forward and #4/#5's
     grads over the whole sequence on one device (1e-4 of max(1, |ref|)).
     Printed: each leg's trajectories, #1-#5's launches per rank, the
     executor mode and why, the collectives' staged bytes, each process's
     peak memory, seconds a step;
 22. one {"kernels": [...]} line, the card's name and power limit, and
     last the {"ok": true, "device": ...} line.

Exits non-zero, printing no result, when there is no CUDA device or when
any check fails.  A served request whose tokens differ from the
sequential Generator's is reported with its first diverging step and the
sequential run's top-2 logit gap there, the remaining phases still run
for their numbers, and the script then exits 1.
"""

from __future__ import annotations

import collections
import functools
import gc
import json
import math
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

SEED = 2024
BATCH = 8
NEW_TOKENS = 32
SRC_LEN = 256
PHASES = {
    # name: (prefix_len, ragged prefix range, cache max_len)
    "A": (8, (1, 8), 256),
    "B": (1024, (512, 1024), 2048),
}
PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_FLOP_PER_S = {           # H100 SXM, dense
    torch.float32: 67e12,     # float32, outside the tensor cores
    torch.bfloat16: 989e12,   # bfloat16 tensor cores
}
TOL = 1e-4                    # kernel vs plain version, float32
BF16_TOL = 2e-2               # kernel vs plain version, bfloat16
LOGITS_TOL = 1e-3             # kernel tiers vs composite, end to end
TF_STEPS = 4                  # teacher-forced steps compared
SEQ = 256                     # training sequence length (bench.py's)
T1_BATCH, T1_STEPS = 16, 4
T2_BATCH, T2_WARMUP, T2_STEPS, T2_PROFILED = 128, 2, 5, 2
LOSS_RTOL_F32 = 1e-4          # T1: kernels vs composite, float32
LOSS_RTOL_BF16 = 2e-2         # T2: first loss, kernels vs composite
LSE_TOL = 1e-4                # flash forward's float32 lse vs plain
PARITY_TOL = 1e-5             # captured vs eager replay of S's step logits
BEAM_K = 4                    # phase Beam's beam_size
BEAM_TOL = 1e-5               # phase Beam: scores, captured vs interpret
# phase S: the Scheduler over the device pool
S_WINDOW, S_PROMPTS, S_MAX_LEN = 2048, (1024, 2048), 4096
S_BLOCK, S_SLOTS, S_PROFILED = 16, 8, 6
# phase L: BERT-base pretraining at 2048 tokens (bench.py's long_2048
# legs: batch max(64 // (S // 512), 4))
L_SEQ = 2048
L1_BATCH, L1_STEPS = 2, 3
L2_BATCH, L2_WARMUP, L2_STEPS, L2_PROFILED = 16, 2, 3, 1
BWD_REPS = 10                 # timed launches of each flash backward case
# phase R: ResNet-50 training (bench.py's resnet50 leg: batch 256, 224x224
# images, 1000 classes, bf16 AMP, Momentum(0.1, 0.9, multi_precision))
R_CLASSES, R_HW = 1000, 224
# R1's learning rate: at bench.py's 0.1 a 3-step float32 trajectory at
# batch 8 is chaotic (a 1e-7 relative change of the images moves the third
# loss by 3% on the port's own CPU path); at 1e-5 it moves it by 2.7e-5
# while the loss still falls 14% in 3 steps
R1_BATCH, R1_STEPS, R1_LR = 8, 3, 1e-5
R1_LOSS_RTOL = 1e-3           # card vs the port's CPU path, float32
R2_BATCH, R2_WARMUP, R2_STEPS, R2_PROFILED = 256, 2, 3, 1
RESNET50_FWD_FLOPS = 4.089e9  # per 224x224 image (bench.py:67)
R_SITES = 16                  # conv3 sites: ResNet-50's 16 bottlenecks
JIT_RTOL = 1e-5               # a step's loss, jit vs interpret (expected 0)
KEEP_TOL = 1e-3               # T2/drop: |kept share of a mask - 0.9|
# [9]'s image legs: bench.py's bench_image_model (bench.py:497-553; the
# build of _setup :186-202: random_seed 1, bf16 AMP, Momentum(0.01, 0.9,
# multi_precision); the feed from RandomState(0)): 2 warm-up, 5 timed and 1
# profiled step each, then a float32 test forward, card vs CPU
IMG_WARMUP, IMG_STEPS, IMG_PROFILED = 2, 5, 1
IMG_RTOL = 1e-3               # cuDNN and the CPU sum in other orders
ImageLeg = collections.namedtuple("ImageLeg", [
    "module", "builder", "kwargs", "batch", "image", "classes",
    "check_batch",            # the float32 test forward's batch
    "reference"])             # the reference's published img/s, or None
IMAGE_LEGS = {   # the K40m rates: bench.py:499-500, BASELINE.md:15-16
    "G": ImageLeg("googlenet", "build", {}, 128, (3, 224, 224), 1000, 8,
                  128 / 1.149),
    "AN": ImageLeg("alexnet", "build", {}, 256, (3, 224, 224), 1000, 8,
                   256 / 0.602),
    "V16": ImageLeg("vgg", "build", {"image_shape": (3, 32, 32),
                                     "class_dim": 10},
                    128, (3, 32, 32), 10, 8, None),
    "MN": ImageLeg("mnist", "build_conv", {}, 256, (1, 28, 28), 10, 8, None),
    "SE": ImageLeg("se_resnext", "build", {}, 128, (3, 224, 224), 1000, 4,
                   None),
}
# phase B/book: the book's main programs (tests/book/_programs), 3 steps
# from the port's own startup, card vs the port's CPU path
BOOK_PROGRAMS = {
    # program: (loss var, feed maker(rng, batch))
    "fit_a_line": ("mean_0.tmp_0", lambda rng, b: {
        "x": rng.standard_normal((b, 13)).astype(np.float32),
        "y": rng.standard_normal((b, 1)).astype(np.float32)}),
    "recognize_digits_mlp": ("mean_1.tmp_0", lambda rng, b: {
        "img": rng.rand(b, 784).astype(np.float32),
        "label": rng.randint(0, 10, (b, 1)).astype(np.int64)}),
    "word2vec": ("mean_2.tmp_0", lambda rng, b: {
        n: rng.randint(0, 1000, (b, 1)).astype(np.int64)
        for n in ("word_0", "word_1", "word_2", "word_3", "target")}),
}
BOOK_BATCH, BOOK_STEPS, BOOK_RTOL = 64, 3, 1e-4
# the image legs' card time by kernel class (profile_calls' classes):
# cuDNN's convolutions with their layout transforms, and the GEMMs, under
# one label
KERNEL_CLASSES = {
    "pooling": ("pool",),
    "copies and casts": ("copy", "Memcpy"),
    "cudnn convs and gemms": ("cudnn", "conv", "Conv", "xmma", "cutlass",
                              "gemm", "Gemm", "tensorTransform",
                              "nchwToNhwc", "nhwcToNchw"),
    "reductions": ("reduce_kernel",),
    "elementwise": ("elementwise",),
}
# phases SL and MT: bench.py's stacked_lstm leg (bench.py:554-605:
# stacked_lstm.build(seq_len=100, hidden_dim=512, stacked_num=2), dict
# 30000, emb 512, batch 64, the 8-batch cycling feed) and its
# machine_translation leg (bench.py:816-853: src and trg 24, dict 10000,
# emb and hidden 256, batch 128); both bf16 AMP with Adam(1e-3,
# multi_precision), random_seed 1 (bench.py's _setup, :186-202)
SL_SEQ, SL_HIDDEN, SL_LAYERS, SL_DICT = 100, 512, 2, 30000
SL1_BATCH, SL2_BATCH = 4, 64
MT_SRC, MT_DICT, MT_EMB, MT_HIDDEN = 24, 10000, 256, 256
MT1_BATCH, MT2_BATCH, MT_DEC_BATCH = 8, 128, 8
RNN1_STEPS = 3                # SL1, MT1: float32 steps, card vs CPU
RNN2_WARMUP, RNN2_STEPS, RNN2_PROFILED = 2, 5, 1
RNN_LOSS_RTOL = 1e-3          # card vs the port's CPU path, float32
TF_LOGITS_TOL = 2e-4          # MT/decode: a step vs the train logits
# the reference's published rate for this leg: 184 ms/batch of 64 on a
# Tesla K40m (benchmark/README.md:112-119, quoted at bench.py:555-556)
SL_K40M_MS = 184.0

KERNELS = {
    "mha_block": {
        "source": "paddle_tpu_torch/csrc/mha_block.cu",
        "replaces": "paddle_tpu/ops/pallas/mha_block.py:109",
        # float32 (SIMT), bf16 (tensor cores), Sq = 1 (both dtypes)
        "device_names": ("mha_fwd_kernel", "mha_fwd_mma_kernel",
                         "mha_decode_kernel"),
    },
    "mha_block_bwd": {
        "source": "paddle_tpu_torch/csrc/mha_block_bwd.cu",
        "replaces": "paddle_tpu/ops/pallas/mha_block.py:120",
        # float32 (SIMT), bf16 (tensor cores: stats, dQ, dK/dV)
        "device_names": ("mha_bwd_dq_kernel", "mha_bwd_dkv_kernel",
                         "mha_bwd_stats_mma_kernel", "mha_bwd_dq_mma_kernel",
                         "mha_bwd_dkv_mma_kernel"),
    },
    "flash_decode": {
        "source": "paddle_tpu_torch/csrc/flash_decode.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:630",
        # one cluster launch a call (body in csrc/decode_stream.cuh)
        "device_names": ("dense_decode_kernel",),
    },
    "flash_decode_paged": {
        "source": "paddle_tpu_torch/csrc/flash_decode_paged.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:793",
        "device_names": ("paged_decode_kernel",),
    },
    "flash_attention_fwd": {
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:205",
        # flash_fwd_kernel: float32 (SIMT); flash_fwd_mma_kernel: bf16
        "device_names": ("flash_fwd_kernel", "flash_fwd_mma_kernel"),
    },
    "flash_attention_bwd_dq": {
        "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:318",
        # float32 (SIMT), bf16 (tensor cores)
        "device_names": ("flash_bwd_dq_kernel", "flash_bwd_dq_mma_kernel"),
    },
    "flash_attention_bwd_dkv": {
        "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:354",
        # float32 (SIMT), bf16 (tensor cores)
        "device_names": ("flash_bwd_dkv_kernel", "flash_bwd_dkv_mma_kernel"),
    },
    "bn_relu_conv1x1": {
        "source": "paddle_tpu_torch/csrc/bn_relu_conv1x1.cu",
        "replaces": "tools/conv1x1_fuse_probe.py:21",
        # float32 (SIMT), bf16 (tensor cores)
        "device_names": ("bn_relu_conv1x1_kernel",
                         "bn_relu_conv1x1_mma_kernel"),
    },
}
# served requests whose tokens differed from the sequential Generator's:
# reported at the end, after every phase ran (the script then exits 1)
DIVERGED = []


def log(*args):
    print(*args, flush=True)


def cuda_sync():
    """Wait for the card once no CUDA graph capture of this process runs
    (paddle_tpu_torch/framework/cuda_graph.synchronize): a device-wide
    synchronisation from this thread would invalidate a capture that a
    server's loop thread has in progress."""
    from paddle_tpu_torch.framework import cuda_graph

    cuda_graph.synchronize()


def reset_peak_memory():
    """Open a phase's peak-memory window.  Garbage cycles of earlier
    phases (an Executor's plans, a Generator's functions) can still hold
    card memory, and when Python's cycle collector frees them depends on
    unrelated allocations: collect them first, so that the peak is the
    phase's own."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


# ---------------------------------------------------------------- timing


def device_spans(prof):
    """(name, start_us, end_us) of every operation the card ran inside a
    torch.profiler window."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]


def busy_us(spans):
    """Time the card was busy: the union of the spans."""
    total, end = 0.0, float("-inf")
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


class Timer:
    """Times one call on the card, with the L2 cache (50 MB) flushed
    before every launch: on the main path each attention reads K/V that
    six other layers' traffic has pushed out of it.

    `ms`: median CUDA-event time around the call (what a caller waits,
    the wrapper's own small copies and launch gaps included).
    `device_ms`: the card's time in the kernels whose names contain
    `names`, per call, from a torch.profiler trace."""

    def __init__(self, device, reps=20, warmup=3):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
        self.reps, self.warmup = reps, warmup

    def ms(self, fn, reps=None):
        for _ in range(self.warmup):
            fn()
        cuda_sync()
        pairs = []
        for _ in range(reps or self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        cuda_sync()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def device_ms(self, fn, names, reps=None):
        from torch.profiler import ProfilerActivity, profile

        reps = reps or self.reps
        cuda_sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                self.flush.zero_()
                fn()
            cuda_sync()
        mine = [s for s in device_spans(prof)
                if any(n in s[0] for n in names)]
        if not mine:
            return None   # the profiler saw no device activity
        return sum(b - a for _, a, b in mine) / reps / 1e3


# CUgraphNodeType: the node types the card runs, by their cuda.h names
_GRAPH_NODE_TYPES = {1: "memcpy", 2: "memset", 3: "host", 4: "child graph",
                     6: "wait event", 7: "record event",
                     8: "signal semaphore", 9: "wait semaphore",
                     10: "mem alloc", 11: "mem free", 12: "batch mem op",
                     13: "conditional"}


def device_ops_of_one_call(fn):
    """The names of the operations one call of fn (after a warm-up call)
    puts on the card, read from a CUDA graph of that call: every node of
    the captured graph, a kernel by its (mangled) name, any other node by
    its type.  Unlike a torch.profiler trace, which now and then holds no
    operation of the card at all, the graph always holds the call whole;
    a call that cannot be captured fails here."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    ptr, size = ctypes.c_void_p, ctypes.c_size_t

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed: CUresult {rc}")

    fn()
    cuda_sync()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda_sync()
    raw = ptr(graph.raw_cuda_graph())
    n = size(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ptr * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ptr(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value == 5:          # an empty node runs nothing
            continue
        if kind.value != 0:
            names.append(_GRAPH_NODE_TYPES.get(kind.value,
                                               f"node type {kind.value}"))
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at 0, kern at 56
        params = (ctypes.c_byte * 256)()
        check(cu.cuGraphKernelNodeGetParams_v2(ptr(node), params),
              "cuGraphKernelNodeGetParams_v2")
        func = ptr.from_buffer(params, 0).value
        kern = ptr.from_buffer(params, 56).value
        name = ctypes.c_char_p()
        if func:
            check(cu.cuFuncGetName(ctypes.byref(name), ptr(func)),
                  "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ptr(kern)),
                  "cuKernelGetName")
        names.append(name.value.decode())
    graph.reset()
    return names


# ------------------------------------------------------- kernel checks


def _us(ms):
    return "not measured" if ms is None else f"{ms * 1e3:.1f} us"


def _lengths(rng, lo, hi, n, device):
    return torch.as_tensor(rng.randint(lo, hi + 1, size=n).astype(np.int64),
                           device=device)


def _sdpa_mask(lens, b, sq, sk, device):
    keys = torch.arange(sk, device=device)
    return (keys[None, :] < lens[:, None]).reshape(b, 1, 1, sk).expand(
        b, 1, sq, sk)


def _heads(x, h):
    b, s, hd = x.shape
    return x.view(b, s, h, hd // h).transpose(1, 2)


def _live(b, sq, sk, causal, key_len, uniform_empty=False):
    """Live (query, key) pairs and live key rows per image, as the kernels
    visit them: keys past key_len and above the causal diagonal are
    skipped.  uniform_empty (mha_block): an image with key_len <= 0 is the
    mean of V over every key, so its rows see all Sk keys, causal or not."""
    kl = [sk] * b if key_len is None else key_len.tolist()
    off = sk - sq
    pairs = rows = 0
    for n in kl:
        if uniform_empty and n <= 0:
            pairs += sq * sk
            rows += sk
            continue
        if causal:
            pairs += sum(min(r + off + 1, n) for r in range(sq))
        else:
            pairs += sq * min(sk, n)
        rows += min(sk, n)
    return pairs, rows


def _shape(b, sq, sk, hd, causal, lens, dtype):
    return (f"q {b}x{sq}x{hd} k {b}x{sk}x{hd}{' causal' if causal else ''}"
            f"{'' if lens is None else f' key_len {lens[0]}-{lens[1]}'}"
            f" {str(dtype).replace('torch.', '')}")


def mha_case(name, b, sq, sk, h, d, causal, lens, device, rng,
             dtype=torch.float32, empty_first=False):
    """Kernel #1; with empty_first, image 0 has key_len 0 (the mean of V
    over every key)."""
    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    q, k, v = (torch.randn((b, s, h * d), generator=g, device=device)
               .to(dtype) for s in (sq, sk, sk))
    key_len = None if lens is None else _lengths(rng, *lens, b, device)
    if empty_first:
        key_len[0] = 0
    pairs, rows = _live(b, sq, sk, causal, key_len, uniform_empty=True)
    item = q.element_size()
    nbytes = item * h * d * (2 * b * sq + 2 * rows) + (
        0 if key_len is None else key_len.numel() * key_len.element_size())
    from paddle_tpu_torch.ops.cuda import mha_block

    kernel = lambda: mha_block.mha_attention(q, k, v, h, causal,  # noqa: E731
                                             key_len=key_len)
    plain = lambda: mha_block.mha_reference(q, k, v, h, causal,  # noqa: E731
                                            key_len=key_len)
    mask = (None if key_len is None
            else _sdpa_mask(key_len, b, sq, sk, device))
    qh, kh, vh = _heads(q, h), _heads(k, h), _heads(v, h)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, attn_mask=mask, is_causal=causal and mask is None)
    # bf16 Sq > 1 runs two sweeps: Q K^T twice, P V once
    two_sweeps = dtype == torch.bfloat16 and sq > 1
    return dict(kernel="mha_block", case=name, fns=(kernel, plain, library),
                shape=_shape(b, sq, sk, h * d, causal, lens, dtype)
                + (" key_len[0] 0" if empty_first else ""),
                dtype=dtype, tol=TOL if dtype == torch.float32 else BF16_TOL,
                flop=4 * d * h * pairs, bytes=nbytes,
                exec_flop=(6 if two_sweeps else 4) * d * h * pairs)


def bwd_case(name, b, sq, sk, h, d, causal, lens, device, rng, dtype):
    """Kernel #2 at a training shape: dq, dk, dv from q, k, v, dO."""
    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    q, k, v, dout = (torch.randn((b, s, h * d), generator=g, device=device)
                     .to(dtype) for s in (sq, sk, sk, sq))
    key_len = None if lens is None else _lengths(rng, *lens, b, device)
    pairs, rows = _live(b, sq, sk, causal, key_len)
    item = q.element_size()
    # q, dO read and dq written; k, v read where live; dk, dv written
    nbytes = item * h * d * (3 * b * sq + 2 * rows + 2 * b * sk) + (
        0 if key_len is None else key_len.numel() * key_len.element_size())
    from paddle_tpu_torch.ops.cuda import mha_block

    kernel = lambda: mha_block.mha_block_bwd(  # noqa: E731
        q, k, v, dout, h, causal, key_len=key_len)
    plain = lambda: mha_block.mha_block_bwd_reference(  # noqa: E731
        q, k, v, dout, h, causal, key_len=key_len)
    mask = (None if key_len is None
            else _sdpa_mask(key_len, b, sq, sk, device))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *(_heads(x, h) for x in leaves), attn_mask=mask,
        is_causal=causal and mask is None)
    g_heads = _heads(dout, h).contiguous()
    library = lambda: torch.autograd.grad(  # noqa: E731
        out, leaves, g_heads, retain_graph=True)
    return dict(kernel="mha_block_bwd", case=name,
                fns=(kernel, plain, library),
                shape=_shape(b, sq, sk, h * d, causal, lens, dtype),
                dtype=dtype, tol=TOL if dtype == torch.float32 else BF16_TOL,
                # dS K, dS^T q, P^T dO and the two recomputed products
                flop=5 * 2 * d * h * pairs, bytes=nbytes,
                # what the kernels compute: S and dP three times over
                # (statistics, dQ, dK/dV), then the three products
                exec_flop=9 * 2 * d * h * pairs)


def decode_case(name, b, sk, h, d, lens, device, rng, dtype=torch.float32):
    """Kernel #6 over a dense cache: kv_len drawn from `lens`, or (lens
    None) every key live, as the translator's decode step feeds it."""
    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    q, k, v = (torch.randn((b, s, h * d), generator=g, device=device)
               .to(dtype) for s in (1, sk, sk))
    kv_len = None if lens is None else _lengths(rng, *lens, b, device)
    live = (b * sk if kv_len is None
            else sum(min(sk, n) for n in kv_len.tolist()))
    from paddle_tpu_torch.ops.cuda import flash_decode

    kernel = lambda: flash_decode.flash_decode(q, k, v, h,  # noqa: E731
                                               kv_len=kv_len)
    plain = lambda: flash_decode.flash_decode_reference(  # noqa: E731
        q, k, v, h, kv_len=kv_len)
    mask = None if kv_len is None else _sdpa_mask(kv_len, b, 1, sk, device)
    qh, kh, vh = _heads(q, h), _heads(k, h), _heads(v, h)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, attn_mask=mask)
    lens_bytes = 0 if kv_len is None else kv_len.numel() * kv_len.element_size()
    return dict(kernel="flash_decode", case=name, fns=(kernel, plain, library),
                shape=f"q {b}x1x{h * d} k {b}x{sk}x{h * d} "
                      + ("all keys live" if lens is None
                         else f"kv_len {lens[0]}-{lens[1]}")
                      + f" {str(dtype).replace('torch.', '')}",
                dtype=dtype, tol=TOL if dtype == torch.float32 else BF16_TOL,
                flop=4 * d * h * live,
                bytes=q.element_size() * h * d * (2 * b + 2 * live)
                + lens_bytes)


def paged_case(name, b, n, bs, lens, h, d, device, rng, dtype,
               max_len=S_MAX_LEN):
    """Kernel #7 at the Scheduler's decode step: pools [n, bs, H*D], one
    table row of max_len / bs block ids per request, drawn from a random
    permutation of the pool."""
    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    hd = h * d
    m = max_len // bs
    q = torch.randn((b, 1, hd), generator=g, device=device).to(dtype)
    kb, vb = (torch.randn((n, bs, hd), generator=g, device=device).to(dtype)
              for _ in range(2))
    table = torch.as_tensor(rng.permutation(n)[:b * m].reshape(b, m),
                            device=device)
    lengths = _lengths(rng, *lens, b, device)
    live = sum(lengths.tolist())
    from paddle_tpu_torch.ops.cuda import flash_decode_paged as fdp

    kernel = lambda: fdp.flash_decode_paged(  # noqa: E731
        q, kb, vb, table, lengths, h)
    plain = lambda: fdp.flash_decode_paged_reference(  # noqa: E731
        q, kb, vb, table, lengths, h)
    # the library call reads a dense view gathered beforehand (not timed)
    kd, vd = (_heads(t[table.reshape(-1)].reshape(b, m * bs, hd), h)
              for t in (kb, vb))
    mask = _sdpa_mask(lengths, b, 1, m * bs, device)
    qh = _heads(q, h)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kd, vd, attn_mask=mask)
    item = q.element_size()
    return dict(kernel="flash_decode_paged", case=name,
                fns=(kernel, plain, library),
                shape=f"q {b}x1x{hd} pool {n}x{bs}x{hd} table {b}x{m} "
                      f"lengths {lens[0]}-{lens[1]} "
                      f"{str(dtype).replace('torch.', '')}",
                dtype=dtype, tol=TOL if dtype == torch.float32 else BF16_TOL,
                flop=4 * d * h * live,
                bytes=item * hd * (2 * b + 2 * live)
                + table.numel() * table.element_size()
                + lengths.numel() * lengths.element_size())


def flash_case(name, b, sq, sk, h, d, causal, lens, device, rng, dtype,
               zero_row=False):
    """Kernel #3's forward: (out, lse).  zero_row sets row 0's kv_len to
    0, which must give out 0 and lse -1e30."""
    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    q, k, v = (torch.randn((b, s, h * d), generator=g, device=device)
               .to(dtype) for s in (sq, sk, sk))
    kv_len = None if lens is None else _lengths(rng, *lens, b, device)
    if zero_row:
        kv_len[0] = 0
    pairs, rows = _live(b, sq, sk, causal, kv_len)
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    kernel = lambda: fa.flash_attention_lse(q, k, v, h, causal,  # noqa: E731
                                            kv_len=kv_len)
    plain = lambda: fa.flash_attention_fwd_reference(  # noqa: E731
        q, k, v, h, causal, kv_len=kv_len)
    mask, is_causal = _flash_mask(kv_len, b, sq, sk, causal, device)
    qh, kh, vh = _heads(q, h), _heads(k, h), _heads(v, h)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, attn_mask=mask, is_causal=is_causal)
    item = q.element_size()
    # q read, out written, live K and V rows read, lse written
    nbytes = item * h * d * (2 * b * sq + 2 * rows) + 4 * b * h * sq + (
        0 if kv_len is None else kv_len.numel() * kv_len.element_size())
    lens_tag = lens if not zero_row else (0, lens[1])
    return dict(kernel="flash_attention_fwd", case=name,
                fns=(kernel, plain, library),
                shape=_shape(b, sq, sk, h * d, causal, lens_tag, dtype),
                dtype=dtype, tol=TOL if dtype == torch.float32 else BF16_TOL,
                err=_flash_err, zero_row=zero_row,
                flop=4 * d * h * pairs, bytes=nbytes)


def _flash_err(out, ref, dtype, zero_row):
    """Max abs error of the flash forward's out; its lse must agree within
    LSE_TOL, and a kv_len-0 row 0 must give out 0 and lse -1e30."""
    (o, lse), (ro, rlse) = out, ref
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        return float("inf")
    lse_err = (lse - rlse).abs().max().item()
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_attention_fwd: lse error {lse_err}")
    if zero_row and not (torch.count_nonzero(o[0]).item() == 0
                         and bool((lse[0] == -1e30).all())):
        raise AssertionError("flash_attention_fwd: the kv_len-0 row is not "
                             "out 0, lse -1e30")
    return (o.float() - ro.float()).abs().max().item()


def _flash_mask(kv_len, b, sq, sk, causal, device):
    """(attn_mask or None, is_causal) giving SDPA the flash tier's live
    pairs: kv_len, and the (Sk - Sq)-offset causal diagonal."""
    mask = None
    if kv_len is not None:
        mask = _sdpa_mask(kv_len, b, sq, sk, device)
    if causal and (mask is not None or sq != sk):
        tri = torch.ones((sq, sk), dtype=torch.bool,
                         device=device).tril(sk - sq)
        mask = tri if mask is None else mask & tri
    return mask, causal and mask is None


def flash_bwd_cases(name, b, sq, sk, h, d, causal, lens, device, rng, dtype,
                    zero_row=False):
    """Kernels #4 and #5 at one shape, one case each, from the plain
    forward's lse and delta (with no lse cotangent, as in the grad op).
    Each case makes its inputs, and the library yardstick's forward
    graph, when it runs, so that only one shape's tensors are alive at a
    time.  zero_row sets row 0's kv_len to 0, which must give dq = dk =
    dv = 0 there."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    seed = int(rng.randint(1 << 30))
    kv_len = None if lens is None else _lengths(rng, *lens, b, device)
    if zero_row:
        kv_len[0] = 0
    pairs, rows = _live(b, sq, sk, causal, kv_len)
    item = torch.empty((), dtype=dtype).element_size()
    # lse and delta read (float32 per row and head), and the lengths
    extra = 8 * b * h * sq + (
        0 if kv_len is None else kv_len.numel() * kv_len.element_size())

    def make(which):
        g = torch.Generator(device=device).manual_seed(seed)
        q, k, v, dout = (torch.randn((b, s, h * d), generator=g,
                                     device=device).to(dtype)
                         for s in (sq, sk, sk, sq))
        out, lse = fa.flash_attention_fwd_reference(q, k, v, h, causal,
                                                    kv_len=kv_len)
        delta = fa.bwd_delta(out, dout, h)
        del out
        args = (q, k, v, dout, lse, delta, h, causal)
        if which == "dq":
            kernel = lambda: (fa.flash_attention_bwd_dq(  # noqa: E731
                *args, kv_len=kv_len),)
            plain = lambda: fa.bwd_reference(  # noqa: E731
                *args, 0.0, kv_len)[:1]
        else:
            kernel = lambda: fa.flash_attention_bwd_dkv(  # noqa: E731
                *args, kv_len=kv_len)
            plain = lambda: fa.bwd_reference(  # noqa: E731
                *args, 0.0, kv_len)[1:]
        mask, is_causal = _flash_mask(kv_len, b, sq, sk, causal, device)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            *(_heads(x, h) for x in leaves), attn_mask=mask,
            is_causal=is_causal)
        g_heads = _heads(dout, h).contiguous()
        library = lambda: torch.autograd.grad(  # noqa: E731
            sdpa_out, leaves, g_heads, retain_graph=True)
        return kernel, plain, library

    shape = _shape(b, sq, sk, h * d, causal,
                   lens if not zero_row else (0, lens[1]), dtype)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    common = dict(case=name, shape=shape, dtype=dtype, tol=tol,
                  err=_bwd_err, zero_row=zero_row, reps=BWD_REPS)
    return [
        # QK^T, dO V^T and dS K on every live pair
        dict(kernel="flash_attention_bwd_dq", fns=functools.partial(
            make, "dq"), flop=6 * d * h * pairs,
            bytes=item * h * d * (3 * b * sq + 2 * rows) + extra, **common),
        # QK^T, dO V^T, P^T dO and dS^T q; dK and dV written for every key
        dict(kernel="flash_attention_bwd_dkv", fns=functools.partial(
            make, "dkv"), flop=8 * d * h * pairs,
            bytes=item * h * d * (2 * b * sq + 2 * rows + 2 * b * sk)
            + extra, **common),
    ]


def conv1x1_case(name, b, c, h, k, device, rng, dtype):
    """Kernel #8 at a conv3 site of ResNet-50's bottlenecks: y [B,C,H,H],
    scale/bias [C] float32, w [C,K].  The library yardstick is F.conv2d
    alone on the activation materialised beforehand; the composite is the
    probe's: the affine + relu materialised, then that conv."""
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.ops.cuda import bn_relu_conv1x1 as brc
    from paddle_tpu_torch.tools import conv1x1_fuse_probe as probe

    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    y = torch.randn((b, c, h, h), generator=g, device=device).to(dtype)
    scale = torch.rand(c, generator=g, device=device) + 0.5
    bias = torch.randn(c, generator=g, device=device) * 0.5
    w = (torch.randn((c, k), generator=g, device=device)
         * c ** -0.5).to(dtype)
    w1c = w.t().reshape(k, c, 1, 1).contiguous()
    act = torch.relu(y.float() * scale.reshape(1, c, 1, 1)
                     + bias.reshape(1, c, 1, 1)).to(dtype)

    def exact(fn):   # float32 convs in full float32, as the port runs them
        def run():
            with nn_ops.cudnn_fp32_exact():
                return fn()
        return run

    kernel = lambda: brc.bn_relu_conv1x1(y, scale, bias, w)  # noqa: E731
    plain = lambda: brc.bn_relu_conv1x1_reference(  # noqa: E731
        y, scale, bias, w)
    library = exact(lambda: torch.nn.functional.conv2d(act, w1c))
    composite = exact(lambda: probe.composite(y, scale, bias, w1c))
    item = y.element_size()
    return dict(kernel="bn_relu_conv1x1", case=name,
                fns=(kernel, plain, library), composite=composite,
                shape=f"y {b}x{c}x{h}x{h} w {c}x{k} "
                      f"{str(dtype).replace('torch.', '')}",
                dtype=dtype, tol=TOL if dtype == torch.float32 else BF16_TOL,
                err=_conv1x1_err, zero_row=False,
                flop=2 * b * h * h * c * k,
                bytes=item * (b * c * h * h + c * k + b * k * h * h) + 8 * c)


def _conv1x1_err(out, ref, dtype, zero_row):
    """Max abs error of #8; in bfloat16 relative to the output's largest
    magnitude."""
    if not torch.isfinite(out).all():
        return float("inf")
    err = (out.float() - ref.float()).abs().max().item()
    if dtype == torch.bfloat16:
        err /= max(ref.float().abs().max().item(), 1e-30)
    return err


def _bwd_err(out, ref, dtype, zero_row):
    """_max_err of a flash backward kernel's outputs; with zero_row, row
    0 of each must be exactly 0."""
    if zero_row and any(torch.count_nonzero(o[0]).item() for o in out):
        raise AssertionError("flash backward: the kv_len-0 row has "
                             "non-zero gradients")
    return _max_err(out, ref, dtype)


def _max_err(out, ref, dtype):
    """Max abs error over the outputs; for the backward in bfloat16,
    relative to each output's largest magnitude."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    errs = []
    for o, r in zip(outs, refs, strict=True):
        if not torch.isfinite(o).all():
            return float("inf")
        e = (o.float() - r.float()).abs().max().item()
        if dtype == torch.bfloat16 and isinstance(out, tuple):
            e /= max(r.float().abs().max().item(), 1e-30)
        errs.append(e)
    return max(errs)


def check_kernels(device):
    """Phase 3: every kernel of the paths at the paths' shapes."""
    rng = np.random.RandomState(SEED)
    h, d = 8, 64
    train = (128, SEQ)
    cases = [
        mha_case("mha_decode 1x256", BATCH, 1, SRC_LEN, h, d, False,
                 (128, SRC_LEN), device, rng),
        mha_case("encoder 256x256", BATCH, SRC_LEN, SRC_LEN, h, d, False,
                 (128, SRC_LEN), device, rng),
        mha_case("causal prefix 1024x1024", BATCH, 1024, 1024, h, d, True,
                 None, device, rng),
        mha_case("cross 1024x256", BATCH, 1024, SRC_LEN, h, d, False,
                 (128, SRC_LEN), device, rng),
    ]
    for b, dtype in ((T1_BATCH, torch.float32), (T2_BATCH, torch.bfloat16)):
        tag = f"b{b} {str(dtype).replace('torch.', '')}"
        cases += [
            mha_case(f"train encoder {tag}", b, SEQ, SEQ, h, d, False, train,
                     device, rng, dtype),
            mha_case(f"train causal {tag}", b, SEQ, SEQ, h, d, True, None,
                     device, rng, dtype),
        ]
    for b, dtype in ((T2_BATCH, torch.bfloat16), (T2_BATCH, torch.float32),
                     (T1_BATCH, torch.float32), (T1_BATCH, torch.bfloat16)):
        tag = f"b{b} {str(dtype).replace('torch.', '')}"
        cases += [
            bwd_case(f"encoder {tag}", b, SEQ, SEQ, h, d, False, train,
                     device, rng, dtype),
            bwd_case(f"causal {tag}", b, SEQ, SEQ, h, d, True, None, device,
                     rng, dtype),
            bwd_case(f"cross {tag}", b, SEQ, SEQ, h, d, False, train, device,
                     rng, dtype),
        ]
    cases.append(decode_case("flash_decode 1x2048", BATCH, 2048, h, d,
                             (512, 1056), device, rng))
    pool = S_MAX_LEN // S_BLOCK * (S_SLOTS + 2)   # the Scheduler's default
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        cases.append(paged_case(f"paged decode {tag}", S_SLOTS, pool,
                                S_BLOCK, (1024, S_MAX_LEN), h, d, device,
                                rng, dtype))
    bert_h = 12                   # BERT-base: 12 heads of 64
    bert_lens = (L_SEQ // 2, L_SEQ)
    cases += [
        flash_case("bert L2 b16 masked bf16", L2_BATCH, L_SEQ, L_SEQ, bert_h,
                   d, False, bert_lens, device, rng, torch.bfloat16),
        flash_case("bert long_4096 b8 masked bf16", 8, 2 * L_SEQ, 2 * L_SEQ,
                   bert_h, d, False, (L_SEQ, 2 * L_SEQ), device, rng,
                   torch.bfloat16),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        cases.append(flash_case(f"prefill 2048 {tag}", S_SLOTS, S_WINDOW,
                                S_WINDOW, h, d, True, None, device, rng,
                                dtype))
    cases += [
        flash_case("off-grid 1000", BATCH, 1000, 1000, h, d, True,
                   (500, 1000), device, rng, torch.float32),
        flash_case("kv_len 0 row", BATCH, 1000, 1000, h, d, False,
                   (500, 1000), device, rng, torch.float32, zero_row=True),
    ]
    # kernels #4 and #5: L2's shape first (the main path's), then the
    # rest of the flash tier's training shapes
    for args in (
        ("bert L2 b16 masked bf16", L2_BATCH, L_SEQ, L_SEQ, bert_h, False,
         bert_lens, torch.bfloat16),
        ("bert b16 bf16", L2_BATCH, L_SEQ, L_SEQ, bert_h, False, None,
         torch.bfloat16),
        ("bert b16 masked f32", L2_BATCH, L_SEQ, L_SEQ, bert_h, False,
         bert_lens, torch.float32),
        ("bert long_4096 b8 masked bf16", 8, 2 * L_SEQ, 2 * L_SEQ, bert_h,
         False, (L_SEQ, 2 * L_SEQ), torch.bfloat16),
        ("causal 2048 b8 bf16", 8, S_WINDOW, S_WINDOW, h, True, None,
         torch.bfloat16),
        ("causal offset 1024x2048 f32", BATCH, 1024, S_WINDOW, h, True,
         None, torch.float32),
    ):
        name, b, sq, sk, heads, causal, lens, dtype = args
        cases += flash_bwd_cases(name, b, sq, sk, heads, d, causal, lens,
                                 device, rng, dtype)
    cases += flash_bwd_cases("off-grid 1000, kv_len 0 row", BATCH, 1000,
                             1000, h, d, False, (500, 1000), device, rng,
                             torch.float32, zero_row=True)
    # kernel #8 at ResNet-50's four conv3 sites (batch 256, bf16; the
    # 14x14 site first: R/probe launches it most), and one float32 case
    for name, (b, c, hh, k), dtype in (
            ("conv3 14x14 b256", (R2_BATCH, 256, 14, 1024), torch.bfloat16),
            ("conv3 56x56 b256", (R2_BATCH, 64, 56, 256), torch.bfloat16),
            ("conv3 28x28 b256", (R2_BATCH, 128, 28, 512), torch.bfloat16),
            ("conv3 7x7 b256", (R2_BATCH, 512, 7, 2048), torch.bfloat16),
            ("conv3 14x14 b64 f32", (64, 256, 14, 1024), torch.float32)):
        cases.append(conv1x1_case(name, b, c, hh, k, device, rng, dtype))
    # the bf16 tensor-core backward at D 128 (q and dO as register
    # fragments over 32-key tiles), beside D 64 above: 4 heads of 128 at
    # T2's shape, 6 heads of 128 at BERT-base L2's
    cases.append(bwd_case("encoder d128 b128 bf16", T2_BATCH, SEQ, SEQ, 4,
                          128, False, train, device, rng, torch.bfloat16))
    cases += flash_bwd_cases("bert L2 d128 b16 masked bf16", L2_BATCH, L_SEQ,
                             L_SEQ, 6, 128, False, bert_lens, device, rng,
                             torch.bfloat16)
    # added last, so that the cases above keep their inputs: #1 in bf16 at
    # Sq = 1, at T2's shape with 4 heads of 128, and a causal batch whose
    # image 0 has key_len 0 (the mean of V over every key); #8 at odd
    # batches, whose pixel tiles cross images at unaligned rows
    cases += [
        mha_case("mha_decode 1x256 bf16", BATCH, 1, SRC_LEN, h, d, False,
                 (128, SRC_LEN), device, rng, torch.bfloat16),
        mha_case("train encoder d128 b128 bf16", T2_BATCH, SEQ, SEQ, 4, 128,
                 False, train, device, rng, torch.bfloat16),
        mha_case("causal key_len 0 b128 bf16", T2_BATCH, SEQ, SEQ, h, d,
                 True, train, device, rng, torch.bfloat16, empty_first=True),
        conv1x1_case("conv3 14x14 b37", 37, 256, 14, 1024, device, rng,
                     torch.bfloat16),
        conv1x1_case("conv3 7x7 b37", 37, 512, 7, 2048, device, rng,
                     torch.bfloat16),
    ]
    # added last, so that the cases above keep their inputs: #7 at phase
    # S's real lengths (prompts of 1024-2048 plus up to 32 new tokens) in
    # both dtypes, and #6 in bf16
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        cases.append(paged_case(
            f"paged decode S {tag}", S_SLOTS, pool, S_BLOCK,
            (S_PROMPTS[0], S_PROMPTS[1] + NEW_TOKENS), h, d, device, rng,
            dtype))
    cases.append(decode_case("flash_decode 1x2048 bf16", BATCH, 2048, h, d,
                             (512, 1056), device, rng, torch.bfloat16))
    # added last: #6 at the GRU translator's decode step (MT/decode): one
    # head of 256 over 24 encoder keys, all live, less than one key block;
    # batch 8 (greedy) and 32 (beam 4 over 8 rows), both dtypes
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for b in (MT_DEC_BATCH, MT_DEC_BATCH * BEAM_K):
            cases.append(decode_case(
                f"MT decode 1x{MT_SRC} d{MT_HIDDEN} b{b} {tag}", b, MT_SRC,
                1, MT_HIDDEN, None, device, rng, dtype))
    # added last: #1 and #2 at [15]'s BERT legs on the mha_block tier,
    # BERT-base's 12 heads of 64 in bf16: S 512 at batch 64 (head chunk
    # 4) and S 1024 at batch 32 (chunk 1), unmasked and with ragged
    # key_len masks of S/2 to S
    for s_len, b in ((512, 64), (1024, 32)):
        for lens in (None, (s_len // 2, s_len)):
            tag = f"bert {s_len} b{b}{'' if lens is None else ' masked'} bf16"
            cases += [
                mha_case(tag, b, s_len, s_len, bert_h, d, False, lens,
                         device, rng, torch.bfloat16),
                bwd_case(tag, b, s_len, s_len, bert_h, d, False, lens,
                         device, rng, torch.bfloat16),
            ]
    # added last: phase [12]'s bench.py legs.  Their prefill windows (32
    # and 16 keys) pass neither kernel gate and take the composite, and
    # mha_decode takes key counts that are multiples of 128 only: the host
    # pool's decode step runs #6 over the dense cache (F/tax and F/sweep:
    # 96 slots at batch 8, kv_len the prompt plus the tokens so far;
    # F/overload: 48 slots at batch 6) and over the source (32 or 16 keys,
    # all live); the device pool's sweep runs #7 over 96-slot tables and
    # #6 over the source
    for b, cache, src, prefix, new in (
            (TAX_STREAMS, TAX_MAX_LEN, TAX_SRC, TAX_PREFIX, TAX_TOKENS),
            (OV_BATCH, OV_MAX_LEN, OV_SRC, OV_PREFIX, OV_TOKENS)):
        cases += [
            decode_case(f"front end 1x{cache} b{b}", b, cache, h, d,
                        (prefix + 1, prefix + new), device, rng),
            decode_case(f"front end source 1x{src} b{b}", b, src, h, d,
                        None, device, rng),
        ]
    cases.append(paged_case(
        "paged decode F/sweep", TAX_STREAMS,
        TAX_MAX_LEN // S_BLOCK * (TAX_STREAMS + 2), S_BLOCK,
        (TAX_PREFIX + 1, TAX_PREFIX + TAX_TOKENS), h, d, device, rng,
        torch.float32, max_len=TAX_MAX_LEN))
    # added last: #3-#5 at [15]'s unmasked flash legs, BERT-base's 12
    # heads of 64 in bf16: long_seq_flash (1024 at batch 32, forced) and
    # long_4096 (batch 8) forward and backward, and long_2048's forward
    # (its backward is "bert b16 bf16" above)
    for s_len, b in ((1024, 32), (2 * L_SEQ, 8), (L_SEQ, 16)):
        tag = f"bert {s_len} b{b} bf16"
        cases.append(flash_case(tag, b, s_len, s_len, bert_h, d, False,
                                None, device, rng, torch.bfloat16))
        if s_len != L_SEQ:
            cases += flash_bwd_cases(tag, b, s_len, s_len, bert_h, d, False,
                                     None, device, rng, torch.bfloat16)
    # added last: #6 inside [18]'s beam body (CF/beam_lm): 8 heads of 64
    # over the 32-slot cache of 8 x 4 beams, kv_len the step (1-32)
    cases.append(decode_case(
        f"CF/beam_lm 1x{CL_MAX_LEN} b{CL_BATCH * CL_BEAM} f32",
        CL_BATCH * CL_BEAM, CL_MAX_LEN, CL_HEADS, CL_D // CL_HEADS,
        (1, CL_MAX_LEN), device, rng))
    timer = Timer(device)
    for c in cases:
        fns = c.pop("fns")
        kernel, plain, library = fns() if callable(fns) else fns
        reps = c.pop("reps", None)
        out, ref = kernel(), plain()
        cuda_sync()
        if "err" in c:
            err = c.pop("err")(out, ref, c["dtype"], c.pop("zero_row"))
        else:
            err = _max_err(out, ref, c["dtype"])
        del out, ref
        if not err <= c["tol"]:
            raise AssertionError(f"{c['kernel']} {c['case']}: max error "
                                 f"{err} > {c['tol']}")
        c["max_abs_err"] = err
        if c["kernel"] in ("flash_decode", "flash_decode_paged"):
            ops = device_ops_of_one_call(kernel)
            names = KERNELS[c["kernel"]]["device_names"]
            if len(ops) != 1 or not any(n in ops[0] for n in names):
                raise AssertionError(f"{c['kernel']} {c['case']}: one call "
                                     f"ran {ops}, not one launch of {names}")
        c["ms"] = timer.ms(kernel, reps)
        c["device_ms"] = timer.device_ms(
            kernel, KERNELS[c["kernel"]]["device_names"], reps)
        c["plain_ms"] = timer.ms(plain, reps)
        c["library_ms"] = timer.ms(library, reps)
        composite = c.pop("composite", None)
        if composite is not None:
            c["composite_ms"] = timer.ms(composite, reps)
        del kernel, plain, library, composite
        dtype = c.pop("dtype")
        t_bytes = c["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = c["flop"] / PEAK_FLOP_PER_S[dtype] * 1e3
        c["bound_ms"] = max(t_bytes, t_ops)
        c["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        # bf16 rate on the device time: the function's FLOP, and (#2)
        # what its kernels compute
        on_card = c["device_ms"] or c["ms"]
        exec_flop = c.pop("exec_flop", c["flop"])
        c["tflops"] = (c["flop"] / on_card / 1e9
                       if dtype == torch.bfloat16 else None)
        rate = ("" if c["tflops"] is None else
                f"{c['tflops']:.1f} TFLOP/s"
                + (f" ({exec_flop / on_card / 1e9:.1f} computed)"
                   if exec_flop != c["flop"] else "") + "  ")
        log(f"  {c['kernel']:13s} {c['case']:24s} [{c['shape']}] "
            f"err {err:.2e}  kernel {c['ms'] * 1e3:9.1f} us (device "
            f"{_us(c['device_ms'])})  plain "
            f"{c['plain_ms'] * 1e3:9.1f} us  library "
            f"{c['library_ms'] * 1e3:9.1f} us  "
            + (f"composite {c['composite_ms'] * 1e3:9.1f} us  "
               if "composite_ms" in c else "")
            + rate + f"bound "
            f"{c['bound_ms'] * 1e3:7.1f} us ({c['bound_by']}: "
            f"{c['flop'] / 1e9:.3f} GFLOP, {c['bytes'] / 1e6:.1f} MB)")
        torch.cuda.empty_cache()
    del timer
    return cases


# ------------------------------------------------------------ main path


def make_feed(rng, prefix_len, prefix_range, vocab):
    src = rng.randint(2, vocab, size=(BATCH, SRC_LEN)).astype(np.int64)
    trg = rng.randint(2, vocab, size=(BATCH, prefix_len + TF_STEPS))
    feed = {
        "src_ids": src,
        "src_lens": rng.randint(128, SRC_LEN + 1, size=BATCH).astype(np.int64),
        "trg_ids": trg[:, :prefix_len].astype(np.int64),
        "prefix_lens": rng.randint(prefix_range[0], prefix_range[1] + 1,
                                   size=BATCH).astype(np.int64),
    }
    return feed, trg.astype(np.int64)


def teacher_forced(gen, feed, trg):
    """Prefill logits, then TF_STEPS steps each fed the target token at the
    row's cursor: [prefill, step 1, ...] as float32 tensors."""
    _, states, lengths, logits = gen._prefill(feed)
    out = [logits.float().clone()]
    for _ in range(TF_STEPS):
        tok = trg[np.arange(BATCH), lengths]
        logits, states = gen._step(tok, lengths, states, feed)
        lengths = lengths + 1
        out.append(logits.float().clone())
    return out


def profile_calls(fn, n, top=5, kernels=(), classes=None):
    """n calls of fn under torch.profiler: host ms per call, the card's
    busy ms per call (union of its operations), the idle share, the
    kernels that take most of the card's time (ms per call), for each
    name of `kernels` (keys of KERNELS) its device ms per call and share
    of the busy time, and with `classes` ({label: name substrings}) the
    device ms per call of each class (a kernel counts in the first class
    whose substring its name holds, else in "other")."""
    from torch.profiler import ProfilerActivity, profile

    cuda_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        cuda_sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = device_spans(prof)
    if not spans:
        return None   # the profiler saw no device activity
    per_kernel = {}
    for name, a, b in spans:
        per_kernel[name[:90]] = per_kernel.get(name[:90], 0.0) + (b - a)
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_us(spans)
    mine = {}
    for name in kernels:
        us = sum(b - a for k, a, b in spans
                 if any(d in k for d in KERNELS[name]["device_names"]))
        mine[name] = {"ms_per_step": round(us / n / 1e3, 4),
                      "share": round(us / busy, 4)}
    by_class = {}
    for name, a, b in spans if classes else ():
        label = next((c for c, subs in classes.items()
                      if any(sub in name for sub in subs)), "other")
        by_class[label] = by_class.get(label, 0.0) + (b - a) / n / 1e3
    return {"steps": n, "step_ms": wall_us / n / 1e3,
            "busy_ms_per_step": busy / n / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "top_kernels_ms_per_step": [[k, round(v / n / 1e3, 4)]
                                        for k, v in ranked],
            "kernels": mine,
            "classes_ms_per_step": {c: round(v, 4)
                                    for c, v in by_class.items()}}


def profile_decode_steps(gen, feed, tok, lengths, states, n_steps,
                         kernels=()):
    """Greedy Generator steps under the profiler (profile_calls)."""
    carry = {"tok": tok, "lengths": lengths, "states": states}

    def one():
        logits, carry["states"] = gen._step(carry["tok"], carry["lengths"],
                                            carry["states"], feed)
        carry["lengths"] = carry["lengths"] + 1
        carry["tok"] = torch.argmax(logits, -1).cpu().numpy()

    return profile_calls(one, n_steps, kernels=kernels)


def run_phase(name, spec, scope, card):
    from paddle_tpu_torch import CUDAPlace, decode, flags
    from paddle_tpu_torch.ops.cuda import flash_decode, mha_block

    prefix_len, prefix_range, max_len = PHASES[name]
    rng = np.random.RandomState(SEED + ord(name))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    feed, trg = make_feed(rng, prefix_len, prefix_range, vocab)
    gen = decode.Generator(spec, scope=scope, place=CUDAPlace(0))
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    # uncounted warm-up: CUDA loads each kernel on its first launch, which
    # would otherwise land in the first phase's generate time
    gen.generate(feed, 2)

    # the main path, counted
    cuda_sync()
    reset_peak_memory()
    mha_block.launches = 0
    flash_decode.launches = 0
    g0 = graph_stats()
    t0 = time.perf_counter()
    tokens = gen.generate(feed, NEW_TOKENS)
    cuda_sync()
    gen_s = time.perf_counter() - t0
    counts = {"mha_block": mha_block.launches,
              "flash_decode": flash_decode.launches}
    peak = torch.cuda.max_memory_allocated()
    graphs = graph_stats(g0)

    if not (tokens.dtype == np.int64 and tokens.ndim == 2
            and tokens.shape[0] == BATCH and 1 <= tokens.shape[1] <= NEW_TOKENS
            and ((tokens >= 0) & (tokens < vocab)).all()):
        raise AssertionError(f"phase {name}: bad tokens {tokens.shape} "
                             f"{tokens.dtype}")
    steps = tokens.shape[1] - 1
    if name == "A":   # prefill: encoder + cross; step: self + cross (mha)
        expect = {"mha_block": 2 * n_layer + 2 * n_layer * steps,
                  "flash_decode": 0}
    else:             # prefill: encoder + causal prefix + cross
        expect = {"mha_block": 3 * n_layer + n_layer * steps,
                  "flash_decode": n_layer * steps}
    if counts != expect:
        raise AssertionError(f"phase {name}: launches {counts}, the gate "
                             f"predicts {expect} for {steps} steps")

    # timed breakdown (uncounted): prefill, then greedy steps from it
    prefill_ms = []
    for _ in range(3):
        cuda_sync()
        t0 = time.perf_counter()
        _, states, lengths, logits = gen._prefill(feed)
        cuda_sync()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    tok = torch.argmax(logits, -1).cpu().numpy()
    n_steps = min(16, max_len - int(lengths.max()))
    cuda_sync()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        logits, states = gen._step(tok, lengths, states, feed)
        lengths = lengths + 1
        tok = torch.argmax(logits, -1).cpu().numpy()
    cuda_sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    profile_steps = profile_decode_steps(
        gen, feed, tok, lengths, states, min(8, max_len - int(lengths.max())),
        kernels=("mha_block",) + (("flash_decode",) if name == "B" else ()))

    # kernel tiers vs the composite, same feeds
    kern = teacher_forced(gen, feed, trg)
    flags.set("flash_attention", "0")
    try:
        comp = teacher_forced(gen, feed, trg)
        comp_tokens = gen.generate(feed, NEW_TOKENS)
    finally:
        flags.reset("flash_attention")
    errs = [(a - b).abs().max().item() for a, b in zip(kern, comp)]
    width = min(tokens.shape[1], comp_tokens.shape[1])
    agree = float((tokens[:, :width] == comp_tokens[:, :width]).mean())
    if not max(errs) <= LOGITS_TOL:
        raise AssertionError(f"phase {name}: kernel tiers vs composite "
                             f"logits differ by {errs} > {LOGITS_TOL}")

    result = {
        "phase": name, "batch": BATCH, "src_len": SRC_LEN,
        "prefix_len": prefix_len, "prefix_lens": list(prefix_range),
        "max_len": max_len, "tokens": list(tokens.shape),
        "launches": counts, "generate_s": gen_s,
        "tokens_per_s": tokens.size / gen_s,
        "prefill_ms": statistics.median(prefill_ms), "step_ms": step_ms,
        "step_profile": profile_steps, "graphs": graphs,
        "peak_mem_mib": peak / 2 ** 20,
        "logits_max_abs_diff_vs_composite": errs,
        "greedy_agreement_vs_composite": agree, "card": card,
    }
    log(f"  phase {name}: {tokens.shape[0]}x{tokens.shape[1]} tokens in "
        f"{gen_s:.3f} s ({result['tokens_per_s']:.1f} tokens/s), prefill "
        f"{result['prefill_ms']:.2f} ms, {step_ms:.3f} ms/step, peak "
        f"{result['peak_mem_mib']:.0f} MiB  [{card}]")
    log(f"    launches {counts}; logits vs composite {errs}; greedy "
        f"agreement {agree:.3f}; CUDA graphs in generate {graphs}")
    log_profile(profile_steps)
    if name == "A":
        result["scheduler"], sched_counts = serve_dense(spec, scope, feed,
                                                        card)
        counts = {k: counts.get(k, 0) + n for k, n in sched_counts.items()}
    return result, counts


def log_profile(prof):
    if prof is not None:
        log(f"    profiled steps: {prof['step_ms']:.3f} ms/step, card busy "
            f"{prof['busy_ms_per_step']:.3f} ms/step, idle share "
            f"{prof['idle_share']:.3f}; top kernels "
            f"{prof['top_kernels_ms_per_step']}")
        if prof["kernels"]:
            log(f"    port kernels (ms/step, share of busy): "
                f"{prof['kernels']}")
        if prof["classes_ms_per_step"]:
            log(f"    card ms/step by kernel class: "
                f"{prof['classes_ms_per_step']}")


def drive_main_path(card):
    """Phase 4: transformer-base served through decode.Generator, greedy
    (A, B) and beam search (Beam)."""
    from paddle_tpu_torch import Scope
    from paddle_tpu_torch.models import transformer

    cfg = transformer.base()
    scope = Scope()   # one model serves every phase, S included
    results, launches = [], {}
    for name, (prefix_len, _, max_len) in PHASES.items():
        spec = decode_spec(cfg, prefix_len, max_len)
        res, counts = run_phase(name, spec, scope, card)
        results.append(res)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    res, counts = phase_beam(card, scope)
    results.append(res)
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    return results, launches, scope


def phase_beam(card, scope):
    """Beam search through decode.Generator.generate(method="beam") on
    transformer.base() in float32, at phase A's feeds (batch 8, 256-token
    sources, prefixes of 1-8 in a 256-slot cache) with beam_size BEAM_K:
    the step program runs at 8 x BEAM_K rows, captured, with #1
    (mha_decode) for its self- and cross-attention.  Beam 1 must give
    greedy's tokens; beam BEAM_K's tokens and scores must equal the same
    search with mode="interpret" (every program replayed eagerly, on the
    card; scores within BEAM_TOL), best beam first.  Launches: 2 #1 a
    layer for the prefill and 2 a layer a step."""
    from paddle_tpu_torch import CUDAPlace, decode
    from paddle_tpu_torch.models import transformer

    prefix_len, prefix_range, max_len = PHASES["A"]
    spec = decode_spec(transformer.base(), prefix_len, max_len)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    feed, _ = make_feed(np.random.RandomState(SEED + ord("A")), prefix_len,
                        prefix_range, vocab)
    place = CUDAPlace(0)
    gen = decode.Generator(spec, scope=scope, place=place)
    greedy = gen.generate(feed, NEW_TOKENS, eos_id=-1)
    one, _ = gen.generate(feed, NEW_TOKENS, method="beam", beam_size=1,
                          eos_id=-1)
    if not np.array_equal(one[:, 0], greedy):
        raise AssertionError("phase Beam: beam 1 differs from greedy")
    gen.generate(feed, 2, method="beam", beam_size=BEAM_K, eos_id=-1)

    # the main path, counted
    cuda_sync()
    reset_peak_memory()
    _zero_counts()
    g0 = graph_stats()
    t0 = time.perf_counter()
    tokens, scores = gen.generate(feed, NEW_TOKENS, method="beam",
                                  beam_size=BEAM_K, eos_id=-1)
    cuda_sync()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated()
    steps = tokens.shape[-1] - 1
    expect = dict.fromkeys(SERVING_KERNELS, 0)
    expect["mha_block"] = 2 * n_layer * (1 + steps)
    if counts != expect:
        raise AssertionError(f"phase Beam: launches {counts}, the gate "
                             f"predicts {expect} for {steps} steps")
    if tokens.shape != (BATCH, BEAM_K, NEW_TOKENS) \
            or not (np.diff(scores, axis=1) <= 0).all():
        raise AssertionError(f"phase Beam: tokens {tokens.shape}, scores "
                             f"{scores.tolist()}")
    eager = decode.Generator(spec, scope=scope, place=place,
                             mode="interpret")
    t0 = time.perf_counter()
    e_tokens, e_scores = eager.generate(feed, NEW_TOKENS, method="beam",
                                        beam_size=BEAM_K, eos_id=-1)
    cuda_sync()
    eager_wall = time.perf_counter() - t0
    err = float(np.abs(scores - e_scores).max())
    if not (np.array_equal(tokens, e_tokens) and err <= BEAM_TOL):
        raise AssertionError(f"phase Beam: captured vs interpret tokens "
                             f"equal {np.array_equal(tokens, e_tokens)}, "
                             f"scores {err}")
    res = {"phase": "Beam", "batch": BATCH, "beam_size": BEAM_K,
           "rows": BATCH * BEAM_K, "src_len": SRC_LEN, "max_len": max_len,
           "tokens": list(tokens.shape), "launches": counts,
           "generate_s": wall, "tokens_per_s": BATCH * NEW_TOKENS / wall,
           "beam_tokens_per_s": BATCH * BEAM_K * NEW_TOKENS / wall,
           "interpret_generate_s": eager_wall,
           "scores_max_abs_diff_vs_interpret": err, "graphs": graphs,
           "peak_mem_mib": peak / 2 ** 20, "beam1_equals_greedy": True,
           "card": card}
    log(f"  phase Beam: {BATCH}x{BEAM_K} beams x {NEW_TOKENS} tokens in "
        f"{wall:.3f} s ({res['tokens_per_s']:.1f} tokens/s of the best "
        f"beam, {res['beam_tokens_per_s']:.1f} over every beam; "
        f"mode=\"interpret\" {eager_wall:.3f} s), scores vs interpret "
        f"{err}, beam 1 = greedy, launches {counts}, CUDA graphs {graphs}, "
        f"peak {res['peak_mem_mib']:.0f} MiB  [{card}]")
    return res, counts


def decode_spec(cfg, prefix_len, max_len, src_len=SRC_LEN, **windows):
    """build_decode (at SRC_LEN by default), every startup seeded;
    `windows` are verify_len / chunk_len."""
    from paddle_tpu_torch.models import transformer

    spec = transformer.build_decode(cfg, src_len=src_len,
                                    prefix_len=prefix_len, max_len=max_len,
                                    **windows)
    for startup in (spec.prefill_startup, spec.step_startup,
                    spec.verify_startup, spec.chunk_startup,
                    spec.encode_startup):
        if startup is not None:
            startup.random_seed = SEED
    return spec


# ------------------------------------------------- serving.Scheduler


SERVING_KERNELS = ("mha_block", "flash_decode", "flash_decode_paged",
                   "flash_attention_fwd")


def launch_counts():
    from paddle_tpu_torch.ops.cuda import (flash_attention, flash_decode,
                                           flash_decode_paged, mha_block)

    return {"mha_block": mha_block.launches,
            "flash_decode": flash_decode.launches,
            "flash_decode_paged": flash_decode_paged.launches,
            "flash_attention_fwd": flash_attention.launches}


def graph_stats(since=None):
    """The CUDA graphs captured (and the seconds spent capturing them),
    replayed and warmed up eagerly since `since` (a graph_stats() dict) or
    since the last reset."""
    from paddle_tpu_torch.framework import cuda_graph

    now = dict(cuda_graph.STATS)
    if since is not None:
        now = {k: v - since[k] for k, v in now.items()}
    now["capture_s"] = round(now["capture_s"], 4) + 0.0   # never -0.0
    return now


def _top2_gap(gen, feed, tokens, t):
    """The sequential Generator's top-2 logit gap where it emits tokens[t],
    teacher-forced on tokens[:t]."""
    _, states, lengths, logits = gen._prefill(feed)
    for tok in tokens[:t]:
        logits, states = gen._step(np.asarray([tok]), lengths, states, feed)
        lengths = lengths + 1
    top = torch.topk(logits.float().reshape(-1), 2).values
    return (top[0] - top[1]).item()


def check_served(phase, reqs, feeds, gen, new_tokens):
    """Every request done, with the sequential batch-1 Generator's tokens
    for its feed.  A divergence is recorded in DIVERGED with its first
    step and the top-2 logit gap there (ROADMAP.md C4)."""
    refs = {}
    for i, (req, feed) in enumerate(zip(reqs, feeds, strict=True)):
        if req.status != "done" or len(req.tokens) != new_tokens:
            raise AssertionError(f"phase {phase}: request {i} {req.status} "
                                 f"with {len(req.tokens)} tokens: "
                                 f"{req.error}")
        key = id(feed)
        if key not in refs:
            refs[key] = gen.generate(feed, new_tokens, eos_id=-1)[0].tolist()
        want = refs[key]
        if req.tokens != want:
            t = next(j for j, (a, b) in enumerate(zip(req.tokens, want))
                     if a != b)
            DIVERGED.append({"phase": phase, "request": i, "step": t,
                             "got": req.tokens[t], "want": want[t],
                             "top2_gap": _top2_gap(gen, feed, want, t)})
            log(f"    DIVERGED {DIVERGED[-1]}")
    return sum(r.tokens == refs[id(f)] for r, f in zip(reqs, feeds))


def serve_dense(spec, scope, feed, card):
    """Phase A's feeds through serving.Scheduler at its default
    paged_kv=False: the host BlockPool, a dense gather of every table a
    step.  Launches: 2 per layer per prefill batch (encoder, cross) and 2
    per layer per step (mha_decode over the 256-slot cache and the
    source)."""
    from paddle_tpu_torch import CUDAPlace, decode, serving

    place = CUDAPlace(0)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    feeds = [{k: v[i:i + 1] for k, v in feed.items()} for i in range(BATCH)]
    sched = serving.Scheduler(spec, scope=scope, place=place,
                              max_batch=BATCH)
    cuda_sync()
    reset_peak_memory()
    _zero_counts()
    g0 = graph_stats()
    t0 = time.perf_counter()
    reqs = [sched.submit(f, NEW_TOKENS, eos_id=-1) for f in feeds]
    sched.run_until_idle()
    cuda_sync()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated()
    c = sched.counters
    expect = dict.fromkeys(SERVING_KERNELS, 0)
    expect["mha_block"] = 2 * n_layer * (c["prefill_batches"] + c["steps"])
    if counts != expect:
        raise AssertionError(f"phase A/scheduler: launches {counts}, the "
                             f"gate predicts {expect} for {c['steps']} "
                             f"steps and {c['prefill_batches']} prefills")
    gen = decode.Generator(spec, scope=scope, place=place)
    equal = check_served("A/scheduler", reqs, feeds, gen, NEW_TOKENS)
    sched.pool.assert_quiesced()
    res = {"paged_kv": False, "requests": len(reqs), "launches": counts,
           "steps": c["steps"], "prefill_batches": c["prefill_batches"],
           "tokens_per_s": len(reqs) * NEW_TOKENS / wall,
           "graphs": graphs, "peak_mem_mib": peak / 2 ** 20,
           "requests_equal_to_sequential": equal, "card": card}
    log(f"    scheduler (paged_kv=False): {len(reqs)}x{NEW_TOKENS} tokens, "
        f"{res['tokens_per_s']:.1f} tokens/s, {c['steps']} steps, launches "
        f"{counts}; CUDA graphs {graphs}, peak "
        f"{res['peak_mem_mib']:.0f} MiB; {equal}/{len(reqs)} requests equal "
        f"the sequential Generator  [{card}]")
    return res, counts


class Recorder:
    """Drives sched.step() and keeps, for every iteration, its host ms,
    its end on the host clock, the deltas of the scheduler's counters, the
    tokens each of `reqs` emitted in it (step() ends on the argmax's copy
    to the host, so the time is the iteration's) and how many programs it
    ran at a signature seen for the first or second time (an eager
    warm-up or a CUDA graph capture)."""

    KEYS = ("steps", "spec_rounds", "draft_steps", "prefill_batches",
            "chunk_passes", "replays", "adopted")

    def __init__(self, sched, reqs=()):
        self.sched, self.reqs, self.log = sched, reqs, []
        self._step = sched.step

    def __call__(self):
        c = self.sched.counters
        before = {k: c[k] for k in self.KEYS}
        toks = [len(r.tokens) for r in self.reqs]
        g0 = graph_stats()
        t0 = time.perf_counter()
        did = self._step()
        t1 = time.perf_counter()
        g = graph_stats(g0)
        rec = {k: c[k] - before[k] for k in self.KEYS}
        rec.update(ms=(t1 - t0) * 1e3, end=t1, emitted=[
            len(r.tokens) - n for r, n in zip(self.reqs, toks)],
            first_time=g["captures"] + g["warmups"])
        self.log.append(rec)
        return did

    def until(self, key, n):
        """Step until `key` has grown by n in total."""
        while sum(r[key] for r in self.log) < n:
            self()

    def pure(self, key):
        """Iterations that did one `key` and no prefill, chunk pass or
        replay."""
        others = {"prefill_batches", "chunk_passes", "replays",
                  "adopted"} - {key}
        return [r for r in self.log
                if r[key] == 1 and not any(r[k] for k in others)]


def _request_feeds(rng, n, vocab):
    """n single-request feeds: 256-token sources (ragged 128-256) and
    2048-token prompt windows with ragged prompts of 1024-2048 tokens."""
    return [{
        "src_ids": rng.randint(2, vocab, size=(1, SRC_LEN)).astype(np.int64),
        "src_lens": np.asarray([rng.randint(128, SRC_LEN + 1)], np.int64),
        "trg_ids": rng.randint(2, vocab, size=(1, S_WINDOW)).astype(np.int64),
        "prefix_lens": np.asarray(
            [rng.randint(S_PROMPTS[0], S_PROMPTS[1] + 1)], np.int64),
    } for _ in range(n)]


def _reset_served(sched):
    """The prefix registry evicted, the pool empty (or it raises), the
    scheduler's counters and samples back to 0."""
    with sched._step_lock:
        sched.pool.assert_quiesced()
        for k in sched.counters:
            sched.counters[k] = 0
        sched.counters["peak_occupancy"] = 0.0
        sched._ttft_samples.clear()
        sched._chunk_samples.clear()
        sched.pool.hits = sched.pool.misses = sched.pool.evictions = 0


def warm_up(sched, groups, new_tokens=3):
    """Uncounted traffic of the counted run's shapes, on other prompts:
    each group of feeds is submitted at once and served to the end, so
    that every program signature it reaches runs once eagerly and, seen
    again, is captured.  Then the prefix registry is evicted, the pool
    must be empty, and the scheduler's counters and samples start from 0.
    Returns the graphs captured and warmed up, and their seconds."""
    g0 = graph_stats()
    t0 = time.perf_counter()
    for group in groups:
        for f in group:
            sched.submit(f, new_tokens, eos_id=-1)
        sched.run_until_idle()
    cuda_sync()
    _reset_served(sched)
    out = graph_stats(g0)
    out["wall_s"] = round(time.perf_counter() - t0, 3)
    return out


def phase_s(card, scope):
    """The Scheduler with paged_kv=True on transformer.base().

    Traffic (16 requests of 32 tokens, 15 distinct prompts): wave 1 is
    prompts 0-6; prompt 0 again after wave 1's 2nd decode step (a prefix
    hit, two tokens behind the rest); wave 2, prompts 7-14, after the 4th
    (admitted when wave 1 finishes, while the repeat still decodes); after
    the 6th, request 3 is evicted and replays (prefill, then its own
    tokens teacher-forced).

    Launches, from the scheduler's own counts: per decode step (replay
    steps included) 6 flash_decode_paged (self-attention through the
    block tables) and 6 mha_block (mha_decode over the 256-token source);
    per prefill batch 6 flash_attention_fwd (causal 2048x2048 decoder
    self-attention: its score tile is over mha_block's budget) and 12
    mha_block (encoder 256x256, cross 2048x256)."""
    from paddle_tpu_torch import CUDAPlace, decode, serving
    from paddle_tpu_torch.models import transformer

    spec = decode_spec(transformer.base(), S_WINDOW, S_MAX_LEN)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    feeds = _request_feeds(np.random.RandomState(SEED + ord("S")), 15, vocab)
    place = CUDAPlace(0)
    sched = serving.Scheduler(spec, scope=scope, place=place,
                              max_batch=S_SLOTS, block_size=S_BLOCK,
                              paged_kv=True)
    tick = Recorder(sched)
    order = []

    def submit(i):
        order.append(feeds[i])
        return sched.submit(feeds[i], NEW_TOKENS, eos_id=-1)

    warm = _request_feeds(np.random.RandomState(_phase_seed("S/warm")), 18,
                          vocab)
    warmed = warm_up(sched, [warm[:8], warm[8:16], warm[16:17],
                             warm[17:]])

    # the main path, counted
    cuda_sync()
    reset_peak_memory()
    _zero_counts()
    g0 = graph_stats()
    t0 = time.perf_counter()
    reqs = [submit(i) for i in range(7)]
    tick.until("steps", 2)
    reqs.append(submit(0))
    tick.until("steps", 4)
    reqs += [submit(i) for i in range(7, 15)]
    tick.until("steps", 6)
    if reqs[3].status != "running":
        raise AssertionError(f"phase S: request 3 is {reqs[3].status}")
    sched.preempt(reqs[3], evict=True)
    while tick():
        pass
    cuda_sync()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated()
    st = sched.stats()

    steps, batches = st["steps"], st["prefill_batches"]
    expect = {"mha_block": n_layer * (steps + 2 * batches),
              "flash_decode": 0,
              "flash_decode_paged": n_layer * steps,
              "flash_attention_fwd": n_layer * batches}
    if counts != expect:
        raise AssertionError(f"phase S: launches {counts}, the gate "
                             f"predicts {expect} for {steps} steps and "
                             f"{batches} prefill batches")
    if st["pool"]["prefix_hits"] < 1 or st["replays"] < 1:
        raise AssertionError(f"phase S: prefix hits "
                             f"{st['pool']['prefix_hits']}, replays "
                             f"{st['replays']}")
    mid_flight = (min(r.first_token_t for r in reqs[8:])
                  < max(r.finish_t for r in reqs[:8]))
    if not mid_flight:
        raise AssertionError("phase S: wave 2 was not admitted while wave "
                             "1 decoded")

    # a few decode steps of 8 prefix hits under the profiler (uncounted)
    for i in range(7, 15):
        sched.submit(feeds[i], S_PROFILED + 2, eos_id=-1)
    tick()
    prof = profile_calls(tick, S_PROFILED,
                         kernels=("flash_decode_paged", "mha_block"))
    sched.run_until_idle()
    parity = capture_parity(sched, feeds[7:15])
    sched.run_until_idle()
    pool_end = sched.pool.assert_quiesced()

    gen = decode.Generator(spec, scope=scope, place=place)
    equal = check_served("S", reqs, order, gen, NEW_TOKENS)
    decode_ms = [r["ms"] for r in tick.pure("steps")]
    prefill_ms = [r["ms"] for r in tick.pure("prefill_batches")]
    res = {"phase": "S", "paged_kv": True, "requests": len(reqs),
           "new_tokens": NEW_TOKENS, "src_len": SRC_LEN, "window": S_WINDOW,
           "prompt_lens": list(S_PROMPTS), "max_len": S_MAX_LEN,
           "block_size": S_BLOCK, "max_batch": S_SLOTS,
           "num_blocks": sched.pool.num_blocks, "launches": counts,
           "steps": steps, "prefill_batches": batches,
           "prefix_hits": st["pool"]["prefix_hits"],
           "replays": st["replays"], "preemptions": st["preemptions"],
           "wall_s": wall, "tokens_per_s": len(reqs) * NEW_TOKENS / wall,
           "ttft_ms": st["ttft_ms"],
           "decode_step_ms": statistics.median(decode_ms),
           "decode_steps_timed": len(decode_ms),
           "prefill_iteration_ms": prefill_ms,
           "step_profile": prof, "peak_mem_mib": peak / 2 ** 20,
           "graphs": graphs, "warm_up": warmed, "capture_parity": parity,
           "peak_occupancy": st["peak_occupancy"], "pool_end": pool_end,
           "requests_equal_to_sequential": equal, "card": card}
    log(f"  phase S: {len(reqs)}x{NEW_TOKENS} tokens in {wall:.3f} s "
        f"({res['tokens_per_s']:.1f} tokens/s), TTFT {st['ttft_ms']}, "
        f"{res['decode_step_ms']:.3f} ms per decode step (median of "
        f"{len(decode_ms)}), prefill iterations "
        f"{[round(ms, 2) for ms in prefill_ms]} ms, peak "
        f"{res['peak_mem_mib']:.0f} MiB, pool "
        f"occupancy peak {st['peak_occupancy']:.3f} of "
        f"{sched.pool.num_blocks} blocks  [{card}]")
    log(f"    {steps} steps, {batches} prefill batches, prefix hits "
        f"{st['pool']['prefix_hits']}, replays {st['replays']}; launches "
        f"{counts}; CUDA graphs {graphs} (warm-up traffic before: "
        f"{warmed}); {equal}/{len(reqs)} requests equal the sequential "
        f"Generator")
    log_profile(prof)
    log(f"    capture parity at one step signature (8 rows): {parity}")
    return res, counts


def capture_parity(sched, feeds):
    """S's paged step at one signature (8 prefix hits decoding), run as
    the Scheduler runs it (a replay of its captured graph) and as an eager
    replay of the same program's ops on the same feed: the logits' max abs
    difference (expected 0; fails above PARITY_TOL) and each run's launch
    counts (must be equal).  Both runs append the same rows at the same
    cursors, so the pool is left as one run leaves it."""
    from paddle_tpu_torch.framework.executor import program_as_function

    for f in feeds:
        sched.submit(f, 6, eos_id=-1)
    for _ in range(4):
        sched.step()
    batch = list(sched._active)
    if len(batch) != len(feeds):
        raise AssertionError(f"phase S: {len(batch)} of {len(feeds)} "
                             "requests decoding for the parity check")
    spec = sched.spec
    fetch = spec.step_fetches()
    feed = sched._window_feed(
        spec, batch, np.asarray([r._last_tok for r in batch]),
        [r._cursor for r in batch], sched._carried + sched._const,
        "_states", sched._paged, tag="step")
    eager = program_as_function(sched._paged_step_program(),
                                sched._gen.scope, fetch, sched.device,
                                mode="interpret")

    def counted(run):
        before = launch_counts()
        with torch.inference_mode():
            outs = run()
        cuda_sync()
        after = launch_counts()
        return outs, {k: after[k] - before[k] for k in after}

    with torch.inference_mode():
        for _ in range(3):   # at this signature: warm-up, capture, replay
            sched._run_paged_exec(feed, fetch)
    g0 = graph_stats()
    cap, cap_counts = counted(lambda: sched._run_paged_exec(feed, fetch))
    replayed = graph_stats(g0)
    ref, ref_counts = counted(lambda: dict(zip(fetch, eager(feed))))
    err = (cap[spec.step_logits].float()
           - ref[spec.step_logits].float()).abs().max().item()
    res = {"rows": len(batch), "max_abs_diff": err,
           "captured_launches": cap_counts, "eager_launches": ref_counts,
           "replayed": replayed["replays"] == 1
           and replayed["captures"] == 0}
    if not (err <= PARITY_TOL and cap_counts == ref_counts
            and res["replayed"]):
        raise AssertionError(f"phase S: capture parity {res}")
    return res


# ------------------------------- the Scheduler's spec, chunk, handoff paths

SPEC_K = 4                    # phase V's verify window
C_CHUNK = 512                 # phases C and H: chunk window rows
C_SHORT = (256, 512)          # phase C's monolithic prompts
H_BLOCK = 32                  # phase H's decode tier: another block size
V_PROFILED = 4                # rounds (V) or iterations (C) profiled


def _phase_seed(name):
    return SEED + sum(map(ord, name))


def _labelled(label, fn):
    """fn inside a profiler range, the card synchronised on both sides, so
    that the kernels it launched run inside the range."""
    from torch.profiler import record_function

    def run(*args, **kwargs):
        cuda_sync()
        with record_function(label):
            out = fn(*args, **kwargs)
            cuda_sync()
        return out

    return run


def profile_labelled(drive, n, patches):
    """n calls of drive() under torch.profiler with `patches` (a list of
    (object, attribute, label)) wrapped by _labelled: host ms and card
    busy ms per call, the idle share, and for each label the card busy
    ms per call of the kernels that started inside its ranges.  The
    wrappers' synchronisations lengthen the host time, so host numbers
    come from unprofiled runs."""
    from torch.profiler import ProfilerActivity, profile

    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for (obj, attr, label), (_, _, fn) in zip(patches, saved):
        setattr(obj, attr, _labelled(label, fn))
    try:
        cuda_sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                drive()
            cuda_sync()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    labels = {label for _, _, label in patches}
    # the ranges themselves appear on the device timeline too (the
    # profiler's annotation spans): count the operations only
    spans = [sp for sp in device_spans(prof) if sp[0] not in labels]
    if not spans:
        return None   # the profiler saw no device activity
    out = {"calls": n, "busy_ms_per_call": busy_us(spans) / n / 1e3,
           "idle_share": 1.0 - busy_us(spans) / wall_us, "labels": {}}
    for _, _, label in patches:
        ranges = [(e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name == label]
        mine = [sp for sp in spans if any(a <= sp[1] < b for a, b in ranges)]
        per_kernel = {}
        for name, a, b in mine:
            per_kernel[name[:80]] = per_kernel.get(name[:80], 0.0) + (b - a)
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:4]
        out["labels"][label] = {
            "ranges": len(ranges), "device_ops": len(mine),
            "busy_ms_per_call": busy_us(mine) / n / 1e3,
            "top_ms_per_call": [[k, round(v / n / 1e3, 4)] for k, v in top]}
    return out


def _label_ms(prof):
    return {k: round(v["busy_ms_per_call"], 4)
            for k, v in prof["labels"].items()}


def _v_expect(c, n_layer, d_layer):
    """Phase V's launches from the scheduler's counters: a plain step
    (replays included) runs #7 and #1 (mha_decode over the source) in
    every target layer, a draft step in every draft layer; the verify
    window runs none (its self-attention is the paged composite, its
    Sq = 4 cross-attention is off #1's grid and under the flash tier's
    floor); a prefill batch runs #3 (causal 2048) and two #1 (encoder,
    cross) per layer of the target and of the draft."""
    plain = c["steps"] - c["spec_rounds"]
    step = n_layer * plain + d_layer * c["draft_steps"]
    return {"mha_block": step + 2 * (n_layer + d_layer)
            * c["prefill_batches"],
            "flash_decode": 0, "flash_decode_paged": step,
            "flash_attention_fwd": (n_layer + d_layer)
            * c["prefill_batches"]}


def phase_v(card, scope, leg):
    """Speculative decoding through serving.Scheduler(spec_decode=True)
    on transformer.base() over the device pool: build_decode(verify_len=
    4), spec_k 4, 8 requests of 32 tokens with prompts of 1024-2048.
    leg "trunc": build_draft(tier="trunc"), 3 decoder layers on the
    target's scope; leg "self": the draft is a second build_decode of the
    target's configuration, so every proposal is accepted; leg "int8"
    ([14]): build_draft(tier="int8"), the full-depth target frozen to
    quantized_matmul on a clone of the scope (the target stays float).

    Traffic: prompts 0-6; prompt 0 again after the 1st round (a prefix
    hit); after the 2nd round request 3 is evicted and replays (target and
    draft teacher-forced in lockstep)."""
    from paddle_tpu_torch import CUDAPlace, decode, serving
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import int8_ops

    name = f"V/{leg}"
    cfg = transformer.base()
    spec = decode_spec(cfg, S_WINDOW, S_MAX_LEN, verify_len=SPEC_K)
    draft_scope = None
    if leg in ("trunc", "int8"):
        draft, draft_scope = transformer.build_draft(
            cfg, src_len=SRC_LEN, prefix_len=S_WINDOW, max_len=S_MAX_LEN,
            tier=leg, scope=scope)
    else:
        draft = decode_spec(cfg, S_WINDOW, S_MAX_LEN)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    d_layer = sum(1 for s in draft.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    feeds = _request_feeds(np.random.RandomState(_phase_seed(name)), 7,
                           vocab)
    place = CUDAPlace(0)
    sched = serving.Scheduler(spec, scope=scope, place=place,
                              max_batch=S_SLOTS, block_size=S_BLOCK,
                              paged_kv=True, spec_decode=True, spec_k=SPEC_K,
                              draft_spec=draft, draft_scope=draft_scope)
    reqs, order = [], []
    tick = Recorder(sched, reqs)

    def submit(i):
        order.append(feeds[i])
        reqs.append(sched.submit(feeds[i], NEW_TOKENS, eos_id=-1))

    # the main path, counted
    cuda_sync()
    reset_peak_memory()
    _zero_counts()
    int8_ops.launches = 0
    g0 = graph_stats()
    t0 = time.perf_counter()
    for i in range(7):
        submit(i)
    tick.until("spec_rounds", 1)
    submit(0)
    tick.until("spec_rounds", 2)
    if reqs[3].status != "running":
        raise AssertionError(f"phase {name}: request 3 is {reqs[3].status}")
    sched.preempt(reqs[3], evict=True)
    while tick():
        pass
    cuda_sync()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    int_mm = int8_ops.launches
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated()
    st = sched.stats()
    expect = _v_expect(st, n_layer, d_layer)
    if (int_mm > 0) != (leg == "int8"):
        raise AssertionError(f"phase {name}: {int_mm} int8 products")
    if counts != expect:
        raise AssertionError(f"phase {name}: launches {counts}, the gate "
                             f"predicts {expect} for {st['steps']} steps, "
                             f"{st['spec_rounds']} rounds, "
                             f"{st['draft_steps']} draft steps and "
                             f"{st['prefill_batches']} prefill batches")
    if st["pool"]["prefix_hits"] < 1 or st["replays"] < 1:
        raise AssertionError(f"phase {name}: prefix hits "
                             f"{st['pool']['prefix_hits']}, replays "
                             f"{st['replays']}")
    rounds = tick.pure("spec_rounds")
    per_row = [n for r in rounds for n in r["emitted"] if n]
    if leg == "self":
        # every proposal accepted: a request's first round emits spec_k
        # tokens; a full acceptance leaves the draft one row behind, so
        # each later round spends a draft step on that row and emits
        # spec_k - 1 (until the budget's last round)
        if st["spec_accepted"] != st["spec_proposed"]:
            DIVERGED.append({"phase": name, "accepted": st["spec_accepted"],
                             "proposed": st["spec_proposed"]})
            log(f"    DIVERGED {DIVERGED[-1]}")

    # a few rounds of 8 prefix hits under the profiler (uncounted): card
    # busy split into the draft steps and the verify window
    for i in range(7):
        sched.submit(feeds[i], 2 * V_PROFILED * SPEC_K + 2, eos_id=-1)
    sched.submit(feeds[0], 2 * V_PROFILED * SPEC_K + 2, eos_id=-1)
    sched.step()
    prof = profile_labelled(sched.step, V_PROFILED, [
        (sched, "_run_draft_step", "draft"),
        (sched, "_run_verify", "verify")])
    # and unlabelled (no synchronising wrapper): the idle share
    plain = profile_calls(sched.step, V_PROFILED // 2)
    sched.run_until_idle()
    pool_end = sched.pool.assert_quiesced()

    gen = decode.Generator(spec, scope=scope, place=place)
    equal = check_served(name, reqs, order, gen, NEW_TOKENS)
    round_ms = [r["ms"] for r in rounds]
    res = {"phase": name, "paged_kv": True, "spec_k": SPEC_K,
           "draft_layers": d_layer, "requests": len(reqs),
           "new_tokens": NEW_TOKENS, "window": S_WINDOW,
           "prompt_lens": list(S_PROMPTS), "max_len": S_MAX_LEN,
           "block_size": S_BLOCK, "max_batch": S_SLOTS, "launches": counts,
           "int8_products": int_mm,
           "steps": st["steps"], "spec_rounds": st["spec_rounds"],
           "draft_steps": st["draft_steps"],
           "prefill_batches": st["prefill_batches"],
           "spec_proposed": st["spec_proposed"],
           "spec_accepted": st["spec_accepted"],
           "acceptance": st["spec_accepted"] / max(1, st["spec_proposed"]),
           "spec_tokens": st["spec_tokens"],
           "tokens_per_row_round": sum(per_row) / max(1, len(per_row)),
           "tokens_per_row_round_hist": {
               str(k): per_row.count(k) for k in sorted(set(per_row))},
           "first_round_tokens": rounds[0]["emitted"] if rounds else None,
           "prefix_hits": st["pool"]["prefix_hits"],
           "replays": st["replays"], "wall_s": wall,
           "tokens_per_s": len(reqs) * NEW_TOKENS / wall,
           "ttft_ms": st["ttft_ms"],
           "round_ms": statistics.median(round_ms) if round_ms else None,
           "rounds_timed": len(round_ms), "round_profile": prof,
           "round_profile_unlabelled": plain, "graphs": graphs,
           "peak_mem_mib": peak / 2 ** 20, "pool_end": pool_end,
           "requests_equal_to_sequential": equal, "card": card}
    log(f"  phase {name}: {len(reqs)}x{NEW_TOKENS} tokens in {wall:.3f} s "
        f"({res['tokens_per_s']:.1f} tokens/s), {st['spec_rounds']} rounds, "
        f"accepted {st['spec_accepted']}/{st['spec_proposed']} "
        f"({res['acceptance']:.3f}), {res['tokens_per_row_round']:.3f} "
        f"tokens per row and round {res['tokens_per_row_round_hist']}, "
        f"{res['round_ms']} ms per round (median of {len(round_ms)}), TTFT "
        f"{st['ttft_ms']}, peak {res['peak_mem_mib']:.0f} MiB  [{card}]")
    log(f"    {st['steps']} target launches, {st['draft_steps']} draft steps, "
        f"{st['prefill_batches']} prefill batches, prefix hits "
        f"{st['pool']['prefix_hits']}, replays {st['replays']}; launches "
        f"{counts}, int8 products {int_mm}; CUDA graphs {graphs}; {equal}/{len(reqs)} requests "
        f"equal the sequential Generator")
    log_profile(plain)
    if prof is not None:
        log(f"    profiled rounds (8 rows): card busy "
            f"{prof['busy_ms_per_call']:.3f} ms per round, idle share "
            f"{prof['idle_share']:.3f} (synchronised wrappers); of it "
            f"{_label_ms(prof)} ms per round; {prof['labels']}")
    return res, counts


def _c_expect(c, n_layer):
    """Phases C and H: a prefill batch runs #3 (causal 2048) and two #1 per
    layer; a chunked request one encode pass (#1 over the source in every
    layer); a chunk window #1 (its 512x256 cross-attention) in every layer
    and no other kernel (its ramp self-attention is the paged composite);
    a decode step #7 and #1 (mha_decode) in every layer."""
    return {"mha_block": n_layer * (2 * c["prefill_batches"] + c["chunked"]
                                    + c["chunk_passes"] + c["steps"]),
            "flash_decode": 0, "flash_decode_paged": n_layer * c["steps"],
            "flash_attention_fwd": n_layer * c["prefill_batches"]}


def _add(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def phase_c(card, scope, spec):
    """Chunked prefill through serving.Scheduler(prefill_chunk=512) on
    transformer.base() over the device pool.  Four requests with prompts
    of 256-512 tokens take the monolithic prefill (#3) and decode; after
    their 2nd decode step four with prompts of 1024-2048 arrive and run
    2-4 chunk windows each, one per loop iteration after the decode step.
    The second long request is exported after its first window and
    imported into a second Scheduler, where it re-chunks from 0."""
    from paddle_tpu_torch import CUDAPlace, decode, serving

    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    rng = np.random.RandomState(_phase_seed("C"))
    short = _request_feeds(rng, 4, vocab)
    for f in short:
        f["prefix_lens"] = np.asarray([rng.randint(C_SHORT[0],
                                                   C_SHORT[1] + 1)], np.int64)
    long = _request_feeds(rng, 4, vocab)
    place = CUDAPlace(0)

    def scheduler():
        return serving.Scheduler(spec, scope=scope, place=place,
                                 max_batch=S_SLOTS, block_size=S_BLOCK,
                                 paged_kv=True, prefill_chunk=C_CHUNK)

    a = scheduler()
    # the paged rewrite of the chunk window is built on its first use, and
    # each program is run eagerly, then captured, at its first two calls
    # of a signature: warm these one-time host costs up on other prompts,
    # so that they stay out of the gaps
    a._chunk_step_program()
    warm = _request_feeds(np.random.RandomState(_phase_seed("C/warm")), 12,
                          vocab)
    for f in warm[:4] + warm[6:10]:
        f["prefix_lens"] = np.asarray([rng.randint(C_SHORT[0],
                                                   C_SHORT[1] + 1)], np.int64)
    # (16 tokens: the short prompts still decode when the long ones
    # graduate, so that the steps reach the 8-row bucket)
    warmed = warm_up(a, [warm[:6], warm[6:]], new_tokens=16)
    reqs = []
    tick = Recorder(a, reqs)

    # the main path, counted
    cuda_sync()
    reset_peak_memory()
    _zero_counts()
    g0 = graph_stats()
    t0 = time.perf_counter()
    reqs += [a.submit(f, NEW_TOKENS, eos_id=-1) for f in short]
    tick.until("steps", 2)
    arrive = len(tick.log)
    reqs += [a.submit(f, NEW_TOKENS, eos_id=-1, request_id=f"long{i}")
             for i, f in enumerate(long)]
    tick.until("chunk_passes", 2)
    moving = reqs[5]
    if moving not in a._prefilling or moving._chunk_pos <= 0:
        raise AssertionError("phase C: request long1 is not mid-prefill")
    record = next(r for r in a.export_requests()
                  if r["request_id"] == "long1")
    moving.cancel()
    while tick():
        pass
    b = scheduler()
    (moved,) = b.import_requests([record])
    b.run_until_idle()
    cuda_sync()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated()
    st, st_b = a.stats(), b.stats()
    expect = _add(_c_expect(st, n_layer), _c_expect(st_b, n_layer))
    if counts != expect:
        raise AssertionError(f"phase C: launches {counts}, the gate "
                             f"predicts {expect} for {st}, {st_b}")
    if moving.status != "cancelled" or st["chunked"] != 4 \
            or st_b["chunked"] != 1:
        raise AssertionError(f"phase C: long1 {moving.status}, chunked "
                             f"{st['chunked']} + {st_b['chunked']}")
    # decode gaps: host time between the ends of consecutive iterations
    # that ran a decode step, from the long arrivals until the last
    # chunked prompt graduated
    last_pass = max(i for i, r in enumerate(tick.log) if r["chunk_passes"])
    stepped = [r for r in tick.log[arrive:last_pass + 2] if r["steps"]]
    gaps = [(b_["end"] - a_["end"]) * 1e3
            for a_, b_ in zip(stepped, stepped[1:])]
    # a gap whose iteration ran a program at a new signature (eagerly, or
    # capturing it)
    first_time = [bool(r["first_time"]) for r in stepped[1:]]
    pass_ms = a.stats()["prefill_chunk_ms"]

    # chunk passes of two fresh long prompts under the profiler
    # (uncounted): card busy per pass
    fresh = _request_feeds(rng, 2, vocab)
    for f in fresh:
        a.submit(f, 2, eos_id=-1)
    a.step()
    prof = profile_labelled(a.step, V_PROFILED, [(a, "_run_chunk", "chunk")])
    # and unlabelled (no synchronising wrapper): the idle share
    for f in _request_feeds(rng, 2, vocab):
        a.submit(f, 2, eos_id=-1)
    a.step()
    plain = profile_calls(a.step, 2)
    a.run_until_idle()
    pool_end = a.pool.assert_quiesced()
    b.pool.assert_quiesced()

    gen = decode.Generator(spec, scope=scope, place=place)
    served = [r for r in reqs if r is not moving] + [moved]
    fed = [f for r, f in zip(reqs, short + long) if r is not moving] \
        + [long[1]]
    equal = check_served("C", served, fed, gen, NEW_TOKENS)
    ttft_long = sorted((r.first_token_t - r.submit_t) * 1e3
                       for r in reqs[4:] if r is not moving)
    res = {"phase": "C", "paged_kv": True, "chunk": C_CHUNK,
           "requests": len(served), "new_tokens": NEW_TOKENS,
           "short_prompts": list(C_SHORT), "long_prompts": list(S_PROMPTS),
           "launches": counts, "steps": st["steps"] + st_b["steps"],
           "prefill_batches": st["prefill_batches"],
           "chunked": st["chunked"] + st_b["chunked"],
           "chunk_passes": st["chunk_passes"] + st_b["chunk_passes"],
           "chunk_pass_ms": pass_ms,
           "decode_gap_ms_max": max(gaps), "decode_gap_ms": gaps,
           "decode_gap_first_time": first_time,
           "decode_gap_ms_max_steady": max(
               [g for g, f in zip(gaps, first_time) if not f], default=None),
           "decode_step_ms": statistics.median(
               r["ms"] for r in tick.pure("steps")),
           "ttft_ms": st["ttft_ms"], "ttft_long_ms": ttft_long,
           "wall_s": wall, "peak_mem_mib": peak / 2 ** 20,
           "pass_profile": prof, "pass_profile_unlabelled": plain,
           "graphs": graphs, "warm_up": warmed, "pool_end": pool_end,
           "requests_equal_to_sequential": equal, "card": card}
    log(f"  phase C: {len(served)}x{NEW_TOKENS} tokens in {wall:.3f} s, "
        f"{res['chunk_passes']} chunk passes of {C_CHUNK} rows "
        f"({pass_ms} ms), longest decode gap "
        f"{res['decode_gap_ms_max']:.2f} ms (gaps "
        f"{[round(g, 2) for g in gaps]}), decode step "
        f"{res['decode_step_ms']:.3f} ms, TTFT {st['ttft_ms']}, long "
        f"prompts' TTFT {[round(t, 1) for t in ttft_long]} ms, peak "
        f"{res['peak_mem_mib']:.0f} MiB  [{card}]")
    log(f"    launches {counts}; CUDA graphs {graphs} (warm-up traffic "
        f"before: {warmed}); gaps whose iteration ran a program at a new "
        f"signature: {first_time}; {equal}/{len(served)} requests equal the "
        f"sequential Generator (one exported mid-prefill)")
    log_profile(plain)
    if prof is not None:
        log(f"    profiled chunk passes: card busy "
            f"{prof['busy_ms_per_call']:.3f} ms each, idle share "
            f"{prof['idle_share']:.3f} (synchronised wrappers); of it "
            f"{_label_ms(prof)} ms; {prof['labels']}")
    return res, counts


def phase_h(card, scope, spec):
    """The two-tier handoff: a prefill-tier Scheduler (prefill_chunk=512,
    blocks of 16) runs four prompts of 1024-2048 tokens with
    prefill_only=True; a decode-tier Scheduler with blocks of 32 resumes
    each from its handoff record (kv_payload, recorded_tokens)."""
    from paddle_tpu_torch import CUDAPlace, decode, serving

    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    feeds = _request_feeds(np.random.RandomState(_phase_seed("H")), 4, vocab)
    place = CUDAPlace(0)
    pre = serving.Scheduler(spec, scope=scope, place=place,
                            max_batch=S_SLOTS, block_size=S_BLOCK,
                            paged_kv=True, prefill_chunk=C_CHUNK)
    dec = serving.Scheduler(spec, scope=scope, place=place,
                            max_batch=S_SLOTS, block_size=H_BLOCK,
                            paged_kv=True)
    spans = {"export": [], "adopt": []}

    def timed(key, fn):
        def run(*args, **kwargs):
            cuda_sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            cuda_sync()
            spans[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    pre.pool.export_rows = timed("export", pre.pool.export_rows)
    dec.pool.adopt_rows = timed("adopt", dec.pool.adopt_rows)

    # the main path, counted
    cuda_sync()
    reset_peak_memory()
    _zero_counts()
    g0 = graph_stats()
    t0 = time.perf_counter()
    handles = [pre.submit(f, NEW_TOKENS, eos_id=-1, prefill_only=True)
               for f in feeds]
    pre.run_until_idle()
    moved, payload_bytes = [], []
    for h in handles:
        if h.status != "prefilled":
            raise AssertionError(f"phase H: {h.status} {h.error}")
        rec = h.handoff
        payload_bytes.append(
            sum(v.nbytes for v in rec["kv"].values())
            + sum(v.nbytes for v in rec["states"].values()))
        moved.append(dec.submit(
            serving.decode_feed(rec["feed"]), rec["max_new_tokens"],
            eos_id=rec["eos_id"], recorded_tokens=rec["tokens"],
            kv_payload={"cursor": rec["cursor"], "rows": rec["kv"],
                        "states": rec["states"],
                        "last_tok": rec["last_tok"],
                        "n_tokens": rec["n_tokens"]}))
    dec.run_until_idle()
    cuda_sync()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated()
    st_p, st_d = pre.stats(), dec.stats()
    expect = _add(_c_expect(st_p, n_layer), _c_expect(st_d, n_layer))
    if counts != expect:
        raise AssertionError(f"phase H: launches {counts}, the gate "
                             f"predicts {expect} for {st_p}, {st_d}")
    if st_p["handoffs"] != len(feeds) or st_d["adopted"] != len(feeds):
        raise AssertionError(f"phase H: {st_p['handoffs']} handoffs, "
                             f"{st_d['adopted']} adopted")
    pre.pool.assert_quiesced()
    pool_end = dec.pool.assert_quiesced()
    gen = decode.Generator(spec, scope=scope, place=place)
    equal = check_served("H", moved, feeds, gen, NEW_TOKENS)
    res = {"phase": "H", "prefill_block_size": S_BLOCK,
           "decode_block_size": H_BLOCK, "chunk": C_CHUNK,
           "requests": len(moved), "launches": counts,
           "chunk_passes": st_p["chunk_passes"], "steps": st_d["steps"],
           "payload_bytes": payload_bytes,
           "prompt_rows": [int(f["prefix_lens"][0]) for f in feeds],
           "export_ms": spans["export"], "adopt_ms": spans["adopt"],
           "ttft_ms": st_p["ttft_ms"], "wall_s": wall, "pool_end": pool_end,
           "graphs": graphs, "peak_mem_mib": peak / 2 ** 20,
           "requests_equal_to_sequential": equal, "card": card}
    log(f"  phase H: {len(moved)} requests handed off ({st_p['chunk_passes']} "
        f"chunk passes on the prefill tier, {st_d['steps']} steps on the "
        f"decode tier), payload "
        f"{[round(n / 2 ** 20, 2) for n in payload_bytes]} MiB for "
        f"{res['prompt_rows']} rows, export "
        f"{[round(ms, 2) for ms in spans['export']]} ms, adopt "
        f"{[round(ms, 2) for ms in spans['adopt']]} ms, prefill-tier TTFT "
        f"{st_p['ttft_ms']}  [{card}]")
    log(f"    launches {counts}; CUDA graphs {graphs}, peak "
        f"{res['peak_mem_mib']:.0f} MiB; {equal}/{len(moved)} requests equal "
        f"the sequential Generator")
    return res, counts


def c10_line(phases, card):
    """ROADMAP C10's check, on a line of its own: phase C's longest gap
    between decode steps against phase S's longest monolithic prefill
    iteration (7-8 prompts), in the same run."""
    by = {p["phase"]: p for p in phases if "phase" in p}
    gap = by["C"]["decode_gap_ms_max"]
    steady = by["C"]["decode_gap_ms_max_steady"]
    prefill = max(by["S"]["prefill_iteration_ms"])
    log(f"  C10: phase C's longest decode gap {gap:.2f} ms (without the "
        f"iterations that ran a program at a new signature: {steady} ms) "
        f"vs phase S's longest monolithic prefill iteration {prefill:.2f} "
        f"ms: {'bounded' if gap < prefill else 'NOT bounded'}  [{card}]")


def drive_scheduler_paths(card, scope):
    """Phases V (trunc, self), C and H on the one model of [4] and [5]."""
    from paddle_tpu_torch.models import transformer

    results, launches = [], {}
    for leg in ("trunc", "self"):
        res, counts = phase_v(card, scope, leg)
        results.append(res)
        launches = _add(launches, counts)
        torch.cuda.empty_cache()
    spec = decode_spec(transformer.base(), S_WINDOW, S_MAX_LEN,
                       chunk_len=C_CHUNK)
    for phase in (phase_c, phase_h):
        res, counts = phase(card, scope, spec)
        results.append(res)
        launches = _add(launches, counts)
        torch.cuda.empty_cache()
    return results, launches


# ------------------------------------------------------------- training


def flops_per_token(cfg):
    """Forward + backward matmul FLOPs per (src + trg) token pair: the
    formula of bench.py's _transformer_flops_per_token, copied."""
    d, ffn, L, V, S = (cfg.d_model, cfg.d_inner, cfg.n_layer,
                       cfg.trg_vocab_size, cfg.max_length)
    enc_layer = 4 * d * d + 2 * d * ffn
    dec_layer = 8 * d * d + 2 * d * ffn  # self + cross attention
    n_matmul = L * (enc_layer + dec_layer) / 2  # per-stream average
    logits = d * V / 2  # only the decoder stream pays the softmax matmul
    attn = 1.5 * L * 2 * S * d
    return 6.0 * (n_matmul + logits) + 3.0 * 2.0 * attn


def build_training(cfg, use_amp, use_src_lens, variant="plain"):
    """transformer.build + Adam(1e-4), as bench.py builds it; `variant`
    is bench.py's PADDLE_TPU_BENCH_FUSED_HEAD ("fused") or _REMAT
    ("remat": RecomputeOptimizer over the model's checkpoints)."""
    from paddle_tpu_torch import (Program, amp, optimizer, program_guard,
                                  unique_name)
    from paddle_tpu_torch.models import transformer

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = SEED
    ckpts = []
    with program_guard(main, startup), unique_name.guard():
        loss, _ = transformer.build(cfg, seq_len=SEQ, checkpoints=ckpts,
                                    fused_head=variant == "fused",
                                    use_src_lens=use_src_lens)
        if use_amp:
            amp.cast_model_to_bf16(main, startup)
        opt = optimizer.Adam(learning_rate=1e-4, multi_precision=use_amp)
        if variant == "remat":
            opt = optimizer.RecomputeOptimizer(opt, checkpoints=ckpts)
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, params_grads


def _persistables(scope, program):
    """Copies of the program's persistables the scope holds (a schedule's
    rate is persistable but exists only once a step has run)."""
    return {v.name: scope.find_var(v.name).clone()
            for v in program.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def _restore(scope, snapshot):
    """Copy the snapshot into the scope's own tensors: a captured step
    binds every persistable where it lies, and one that moved would be
    copied into its graph at every call."""
    for name, value in snapshot.items():
        scope.find_var(name).copy_(value)


def _scratch(main, scope):
    """A scope holding a copy of `scope`'s persistables and run counter.
    The allocator caches blocks per stream, and the jit path's warm-up
    runs on a side stream: the cache is released first, so that the two
    streams' caches never sit on the card together."""
    from paddle_tpu_torch import Scope
    from paddle_tpu_torch.framework.executor import _RNG_COUNTER_NAME

    torch.cuda.empty_cache()
    scratch = Scope()
    for name, value in _persistables(scope, main).items():
        scratch.set_var(name, value)
    scratch.set_var(_RNG_COUNTER_NAME, scope.find_var(_RNG_COUNTER_NAME))
    return scratch


def _interpret_step(eager, main, scope, feed, loss):
    """One step by the interpreter in a _scratch copy of `scope`: [loss].
    The cache is released after the step too."""
    scratch = _scratch(main, scope)
    losses, _ = run_steps(eager, main, scratch, feed, loss, 1)
    del scratch
    torch.cuda.empty_cache()
    return losses


def jit_vs_interpret(phase, exe, main, scope, feed, loss, n):
    """n steps on the default path (`exe`, jit), each run first by the
    interpreter in a scratch scope from the same persistables and run
    counter; the losses must agree within rtol 1e-5 (expected 0).
    Returns (jit losses, interpret losses)."""
    from paddle_tpu_torch import Executor

    eager = Executor(exe.device, mode="interpret")
    jit, ref = [], []
    for _ in range(n):
        ref += _interpret_step(eager, main, scope, feed, loss)
        jit += run_steps(exe, main, scope, feed, loss, 1)[0]
    if not np.allclose(jit, ref, rtol=JIT_RTOL, atol=0):
        raise AssertionError(f"{phase}: jit losses {jit} vs interpret {ref}")
    return jit, ref


def captured_graphs(phase, exe, feed):
    """The graphs `exe` captured: (graphs, arguments bound).  Raises if
    none was captured, or if a graph copies in at every call an argument
    that is not a feed (a persistable that moved)."""
    from paddle_tpu_torch.framework.cuda_graph import CapturedSegment

    n_graphs = n_bound = 0
    for plan in exe._cache.values():
        for seg in plan:
            fn = getattr(seg, "fn", None)
            if not isinstance(fn, CapturedSegment):
                continue
            for g in fn._graphs.values():
                copied = {seg.in_names[i] for i, _, _ in g.copied} - set(feed)
                if copied:
                    raise AssertionError(
                        f"{phase}: segment {fn.label} copies {sorted(copied)} "
                        "in at every call")
                n_graphs += 1
                n_bound += len(g.bound)
    if not n_graphs:
        raise AssertionError(f"{phase}: no step was captured")
    return n_graphs, n_bound


def capture_fields(before, prof, ms_per_step):
    """A training phase's CUDA graphs since `before` (captured, seconds,
    graph-pool MiB, replays, eager warm-ups), the card's busy ms a step
    and the idle share, profiled and as 1 - card / host."""
    gs = graph_stats(before)
    busy = prof["busy_ms_per_step"] if prof else None
    return {"graphs_captured": gs["captures"], "capture_s": gs["capture_s"],
            "graph_pool_mib": gs["pool_bytes"] / 2 ** 20,
            "replays": gs["replays"], "warmups": gs["warmups"],
            "card_busy_ms_per_step": busy,
            "idle_share_profiled": prof["idle_share"] if prof else None,
            "idle_share_unprofiled": (1.0 - busy / ms_per_step
                                      if busy else None),
            "peak_mem_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
            "peak_reserved_mib": torch.cuda.max_memory_reserved() / 2 ** 20}


def log_capture(phase, res):
    log(f"    {phase} captured: {res['graphs_captured']} graphs "
        f"({res['capture_s']} s, pool {res['graph_pool_mib']:.0f} MiB), "
        f"{res['replays']} replays, {res['warmups']} warm-ups; card busy "
        f"{res['card_busy_ms_per_step']} ms/step, idle share profiled "
        f"{res['idle_share_profiled']}, unprofiled "
        f"{res['idle_share_unprofiled']}; peak {res['peak_mem_mib']:.0f} "
        f"MiB allocated, {res['peak_reserved_mib']:.0f} MiB reserved")


def _train_feed(cfg, batch, seed, ragged, device):
    from paddle_tpu_torch.models import transformer

    feed = transformer.synthetic_batch(batch, cfg, seq_len=SEQ, seed=seed)
    if ragged:
        feed["src_lens"] = np.random.RandomState(seed).randint(
            SEQ // 2, SEQ + 1, size=batch).astype(np.int64)
    # staged on the card once, as bench.py stages its batch
    return {k: torch.as_tensor(v, device=device) for k, v in feed.items()}


def run_steps(exe, main, scope, feed, loss, n, fetch_grads=(), probe=()):
    """n training steps; returns the losses and the first step's `probe`
    values and grads.  `probe` is fetched at every step, so that every
    step runs the one plan."""
    losses, grads = [], None
    for i in range(n):
        fetch = [loss] + list(probe) + (list(fetch_grads) if i == 0 else [])
        outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)
        losses.append(float(outs[0].float().reshape(-1)[0]))
        if i == 0:
            grads = outs[1:]
    return losses, grads


def _counts():
    from paddle_tpu_torch.ops.cuda import mha_block

    return {"mha_block": mha_block.launches,
            "mha_block_bwd": mha_block.bwd_launches}


def _zero_counts():
    from paddle_tpu_torch.ops.cuda import (bn_relu_conv1x1, flash_attention,
                                           flash_decode, flash_decode_paged,
                                           mha_block)

    mha_block.launches = mha_block.bwd_launches = flash_decode.launches = 0
    flash_decode_paged.launches = flash_attention.launches = 0
    flash_attention.bwd_dq_launches = flash_attention.bwd_dkv_launches = 0
    bn_relu_conv1x1.launches = 0


def _grad_diff(names, got, want):
    """(max over params of max |got - want| / max |want|, that param, the
    L2 ratio over all grads).  A relu mask flipped by a last-bit
    difference upstream moves single entries of the weights that feed the
    relu, which the max sees and the L2 ratio barely does."""
    rel, worst = max((
        (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30), n)
        for n, a, b in zip(names, got, want, strict=True))
    l2 = (sum((a - b).double().square().sum().item()
              for a, b in zip(got, want))
          / sum(b.double().square().sum().item() for b in want)) ** 0.5
    return rel, worst, l2


def phase_t1(card, device):
    """float32, batch 16, ragged source lengths: kernels vs composite."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags
    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig(max_length=SEQ, dropout=0.0)
    main, startup, loss, params_grads = build_training(cfg, False, True)
    n_attn = sum(op.type == "fused_attention"
                 for op in main.global_block().ops)
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    start = _persistables(scope, main)
    feed = _train_feed(cfg, T1_BATCH, SEED + 1, True, device)
    grads = [g.name for _, g in params_grads]

    cuda_sync()
    _zero_counts()
    t0 = time.perf_counter()
    losses, g_kernel = run_steps(exe, main, scope, feed, loss, T1_STEPS,
                                 grads)
    cuda_sync()
    wall = time.perf_counter() - t0
    counts = _counts()
    expect = {"mha_block": n_attn * T1_STEPS,
              "mha_block_bwd": n_attn * T1_STEPS}
    if counts != expect:
        raise AssertionError(f"T1: launches {counts}, expected {expect}")

    _restore(scope, start)
    flags.set("flash_attention", "0")
    try:
        comp, g_comp = run_steps(exe, main, scope, feed, loss, T1_STEPS,
                                 grads)
    finally:
        flags.reset("flash_attention")
    if not (np.all(np.isfinite(losses))
            and np.allclose(losses, comp, rtol=LOSS_RTOL_F32, atol=0)):
        raise AssertionError(f"T1: losses {losses} vs composite {comp}")
    # the first step once more on the kernels: how far the step's own
    # run-to-run differences go (index_add_ sums with atomics)
    _restore(scope, start)
    _, g_again = run_steps(exe, main, scope, feed, loss, 1, grads)
    rel, worst, l2 = _grad_diff(grads, g_kernel, g_comp)
    rerun, _, _ = _grad_diff(grads, g_again, g_kernel)
    # each step twice from the same state and run counter: the captured
    # graph's replay and the interpreter
    _restore(scope, start)
    jit, ref = jit_vs_interpret("T1", exe, main, scope, feed, loss, T1_STEPS)
    graphs, bound = captured_graphs("T1", exe, feed)
    res = {"phase": "T1", "dtype": "float32", "batch": T1_BATCH, "seq": SEQ,
           "steps": T1_STEPS, "launches": counts, "losses": losses,
           "composite_losses": comp, "max_rel_grad_diff": rel,
           "max_rel_grad_diff_param": worst, "l2_rel_grad_diff": l2,
           "rerun_max_rel_grad_diff": rerun, "jit_losses": jit,
           "interpret_losses": ref, "graphs": graphs, "bound_args": bound,
           "ms_per_step": wall / T1_STEPS * 1e3, "card": card}
    log(f"  T1 float32 batch {T1_BATCH}: losses {losses}; composite {comp}; "
        f"largest relative grad difference {rel:.3e} ({worst}), L2 "
        f"{l2:.3e}, kernels rerun {rerun:.3e}; launches {counts}; "
        f"{res['ms_per_step']:.1f} ms/step; jit {jit} = interpret {ref}; "
        f"{graphs} graphs, {bound} arguments bound  [{card}]")
    return res, counts


def phase_t2(card, device):
    """bench.py's transformer configuration: batch 128, seq 256, bf16 AMP,
    Adam(1e-4, multi_precision=True)."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags
    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig(max_length=SEQ, dropout=0.0)
    main, startup, loss, _ = build_training(cfg, True, False)
    n_attn = sum(op.type == "fused_attention"
                 for op in main.global_block().ops)
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = _train_feed(cfg, T2_BATCH, SEED + 2, False, device)

    start = _persistables(scope, main)
    flags.set("flash_attention", "0")
    try:
        (comp_first,), _ = run_steps(exe, main, scope, feed, loss, 1)
    finally:
        flags.reset("flash_attention")
    _restore(scope, start)
    del start
    torch.cuda.empty_cache()

    cuda_sync()
    _zero_counts()
    before = graph_stats()
    reset_peak_memory()
    # the first step runs eagerly, the second is captured, later ones replay
    warm, _ = run_steps(exe, main, scope, feed, loss, T2_WARMUP)
    cuda_sync()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, T2_STEPS)
    cuda_sync()
    wall = time.perf_counter() - t0
    prof = profile_calls(
        lambda: run_steps(exe, main, scope, feed, loss, 1), T2_PROFILED,
        top=8, kernels=("mha_block", "mha_block_bwd"))
    counts = _counts()
    n_steps = T2_WARMUP + T2_STEPS + T2_PROFILED
    expect = {"mha_block": n_attn * n_steps,
              "mha_block_bwd": n_attn * n_steps}
    if counts != expect:
        raise AssertionError(f"T2: launches {counts}, expected {expect}")
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"T2: losses {losses}")
    if abs(losses[0] - comp_first) > LOSS_RTOL_BF16 * abs(comp_first):
        raise AssertionError(f"T2: first loss {losses[0]} vs composite "
                             f"{comp_first}")
    graphs, bound = captured_graphs("T2", exe, feed)
    tokens_per_s = 2 * T2_BATCH * SEQ * T2_STEPS / wall   # src + trg
    res = {"phase": "T2", "dtype": "bfloat16 AMP", "batch": T2_BATCH,
           "seq": SEQ, "warmup": T2_WARMUP, "steps": T2_STEPS,
           "launches": counts, "losses": losses,
           "composite_first_loss": comp_first,
           "tokens_per_s": tokens_per_s, "ms_per_step": wall / T2_STEPS * 1e3,
           "mfu": tokens_per_s * flops_per_token(cfg) /
           PEAK_FLOP_PER_S[torch.bfloat16],
           "flops_per_token": flops_per_token(cfg), "graphs": graphs,
           "bound_args": bound, "profile": prof, "card": card}
    res.update(capture_fields(before, prof, res["ms_per_step"]))
    log(f"  T2 bf16 AMP batch {T2_BATCH}: {tokens_per_s:.1f} tokens/s, "
        f"{res['ms_per_step']:.2f} ms/step, MFU {res['mfu']:.4f}; losses "
        f"{losses}; composite first {comp_first}; launches {counts}  "
        f"[{card}]")
    log_capture("T2", res)
    log_profile(prof)
    return res, counts


def _mask_elements(main, batch):
    """Elements of every dropout mask of one step at `batch`."""
    block = main.global_block()
    return sum(int(np.prod([batch if d == -1 else d for d in
                            block.var(op.output("Mask")[0]).shape]))
               for op in block.ops if op.type == "dropout")


def phase_t2drop(card, device):
    """Transformer-base at its published configuration (dropout 0.1) in
    T2's step: batch 128, seq 256, bf16 AMP, Adam(1e-4,
    multi_precision=True), captured.  Every step also fetches the first
    dropout's mask.  The eager warm-up and the capture each equal the
    interpreter's step from the same state and run counter; the last two
    replays draw different masks, 0.9 of each kept."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope
    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig(max_length=SEQ)
    main, startup, loss, _ = build_training(cfg, True, False)
    ops = main.global_block().ops
    n_attn = sum(op.type == "fused_attention" for op in ops)
    n_drop = sum(op.type == "dropout" for op in ops)
    mask = next(op.output("Mask")[0] for op in ops if op.type == "dropout")
    scope, exe = Scope(), Executor(CUDAPlace(0))
    eager = Executor(CUDAPlace(0), mode="interpret")
    exe.run(startup, scope=scope)
    feed = _train_feed(cfg, T2_BATCH, SEED + 6, False, device)
    masks = []

    def step():
        out, m = exe.run(main, feed=feed, fetch_list=[loss, mask],
                         scope=scope, return_numpy=False)
        masks[:] = masks[-1:] + [m]
        return float(out.float().reshape(-1)[0])

    cuda_sync()
    _zero_counts()
    before = graph_stats()
    reset_peak_memory()
    # the eager warm-up and the capture, each after the interpreter's step
    # from the same persistables and run counter in a scratch scope
    warm, ref = [], []
    for _ in range(T2_WARMUP):
        ref += _interpret_step(eager, main, scope, feed, loss)
        warm.append(step())
    if not np.allclose(warm, ref, rtol=JIT_RTOL, atol=0):
        raise AssertionError(f"T2/drop: jit losses {warm} vs interpret {ref}")
    cuda_sync()
    t0 = time.perf_counter()
    timed = [step() for _ in range(T2_STEPS)]
    cuda_sync()
    wall = time.perf_counter() - t0
    prof = profile_calls(step, T2_PROFILED, top=8,
                         kernels=("mha_block", "mha_block_bwd"))
    res = capture_fields(before, prof, wall / T2_STEPS * 1e3)
    counts = _counts()
    n_steps = 2 * T2_WARMUP + T2_STEPS + T2_PROFILED
    expect = {"mha_block": n_attn * n_steps,
              "mha_block_bwd": n_attn * n_steps}
    if counts != expect:
        raise AssertionError(f"T2/drop: launches {counts}, expected {expect}")
    if torch.equal(masks[0], masks[1]):
        raise AssertionError("T2/drop: two consecutive replays drew the "
                             "same mask")
    kept = [float((m != 0).float().mean()) for m in masks]
    if max(abs(k - 0.9) for k in kept) > KEEP_TOL:
        raise AssertionError(f"T2/drop: kept shares {kept}, expected 0.9")
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"T2/drop: losses {losses}")
    graphs, bound = captured_graphs("T2/drop", exe, feed)
    tokens_per_s = 2 * T2_BATCH * SEQ * T2_STEPS / wall
    res.update({
        "phase": "T2/drop", "dtype": "bfloat16 AMP", "dropout": cfg.dropout,
        "batch": T2_BATCH, "seq": SEQ, "warmup": T2_WARMUP,
        "steps": T2_STEPS, "launches": counts, "losses": losses,
        "interpret_losses": ref, "dropouts_per_step": n_drop,
        "mask_elements_per_step": _mask_elements(main, T2_BATCH),
        "kept_share": kept, "tokens_per_s": tokens_per_s,
        "ms_per_step": wall / T2_STEPS * 1e3,
        "mfu": tokens_per_s * flops_per_token(cfg) /
        PEAK_FLOP_PER_S[torch.bfloat16], "graphs": graphs,
        "bound_args": bound, "profile": prof, "card": card})
    log(f"  T2/drop bf16 AMP batch {T2_BATCH}, dropout {cfg.dropout} "
        f"({n_drop} dropouts, {res['mask_elements_per_step']} mask elements "
        f"a step): {tokens_per_s:.1f} tokens/s, {res['ms_per_step']:.2f} "
        f"ms/step, MFU {res['mfu']:.4f}; losses {losses}; warm-up and "
        f"capture vs interpret {ref}; kept shares of the last two masks "
        f"{kept}, they differ; launches {counts}  [{card}]")
    log_capture("T2/drop", res)
    log_profile(prof)
    return res, counts


def drive_training(card, device):
    """Phase 6: transformer.base() trained through Executor.run (T1, T2;
    main() runs T2/drop after them)."""
    results, launches = [], {}
    for phase in (phase_t1, phase_t2):
        res, counts = phase(card, device)
        results.append(res)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        torch.cuda.empty_cache()
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {k} never launched on the "
                                 "training path")
    return results, launches


# ------------------------------------------------ BERT at 2048 tokens


def bert_flops_per_token(cfg, seq):
    """Forward + backward matmul FLOPs per input token: the formula of
    bench.py's _bert_flops_per_token, copied."""
    h, f, L, v, m = (cfg.hidden, cfg.ffn, cfg.layers, cfg.vocab_size,
                     cfg.max_predictions)
    per_layer = 8 * h * h + 4 * h * f + 4 * seq * h  # qkv+out, ffn, scores+ctx
    mlm = (m / seq) * (2 * h * h + 2 * h * v)  # transform + tied logits
    pooler = 2 * h * h / seq
    return 3.0 * (L * per_layer + mlm + pooler)


def build_bert(cfg, use_amp, masked=True, variant="plain"):
    """bert.build + Adam(1e-4), as bench.py's _bench_bert_at builds its
    legs (masked: use_input_mask); `variant` "fused" (fused_head) or
    "remat" (RecomputeOptimizer over the encoder layers' outputs)."""
    from paddle_tpu_torch import (Program, amp, optimizer, program_guard,
                                  unique_name)
    from paddle_tpu_torch.models import bert

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = SEED
    ckpts = []
    with program_guard(main, startup), unique_name.guard():
        loss = bert.build(cfg, checkpoints=ckpts,
                          fused_head=variant == "fused",
                          use_input_mask=masked)[0]
        if use_amp:
            amp.cast_model_to_bf16(main, startup)
        opt = optimizer.Adam(learning_rate=1e-4, multi_precision=use_amp)
        if variant == "remat":
            opt = optimizer.RecomputeOptimizer(opt, checkpoints=ckpts)
        opt.minimize(loss)
    return main, startup, loss


def _bert_setup(batch, use_amp, seed, device):
    """BERT-base at L_SEQ tokens (dropout 0): the program, its startup run
    on the card, the starting persistables and a staged ragged batch."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(max_positions=L_SEQ, dropout=0.0)
    main, startup, loss = build_bert(cfg, use_amp)
    n_attn = sum(op.type == "fused_attention"
                 for op in main.global_block().ops)
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = bert.synthetic_batch(batch, cfg, seed=seed, use_input_mask=True)
    feed = {k: torch.as_tensor(v, device=device) for k, v in feed.items()}
    return cfg, main, loss, n_attn, scope, exe, feed


def _bert_counts():
    from paddle_tpu_torch.ops.cuda import flash_attention, mha_block

    return {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_bwd_dq": flash_attention.bwd_dq_launches,
            "flash_attention_bwd_dkv": flash_attention.bwd_dkv_launches,
            "mha_block": mha_block.launches,
            "mha_block_bwd": mha_block.bwd_launches}


def _bert_expect(n_attn, steps):
    """Per step and attention: #3 in the forward and again in the grad
    (out and lse recomputed), #4 and #5 once; no mha_block."""
    return {"flash_attention_fwd": 2 * n_attn * steps,
            "flash_attention_bwd_dq": n_attn * steps,
            "flash_attention_bwd_dkv": n_attn * steps,
            "mha_block": 0, "mha_block_bwd": 0}


def _real_tokens(feed):
    return int(feed["input_mask"].float().sum().item())


def phase_l1(card, device):
    """float32, batch 2, ragged masks: kernels vs composite."""
    from paddle_tpu_torch import flags

    cfg, main, loss, n_attn, scope, exe, feed = _bert_setup(
        L1_BATCH, False, SEED + 3, device)
    start = _persistables(scope, main)
    cuda_sync()
    _zero_counts()
    t0 = time.perf_counter()
    losses, _ = run_steps(exe, main, scope, feed, loss, L1_STEPS)
    cuda_sync()
    wall = time.perf_counter() - t0
    counts = _bert_counts()
    expect = _bert_expect(n_attn, L1_STEPS)
    if counts != expect:
        raise AssertionError(f"L1: launches {counts}, expected {expect}")
    _restore(scope, start)
    flags.set("flash_attention", "0")
    try:
        comp, _ = run_steps(exe, main, scope, feed, loss, L1_STEPS)
    finally:
        flags.reset("flash_attention")
    if not (np.all(np.isfinite(losses))
            and np.allclose(losses, comp, rtol=LOSS_RTOL_F32, atol=0)):
        raise AssertionError(f"L1: losses {losses} vs composite {comp}")
    _restore(scope, start)
    jit, ref = jit_vs_interpret("L1", exe, main, scope, feed, loss, L1_STEPS)
    graphs, bound = captured_graphs("L1", exe, feed)
    res = {"phase": "L1", "dtype": "float32", "batch": L1_BATCH,
           "seq": L_SEQ, "steps": L1_STEPS, "real_tokens": _real_tokens(feed),
           "launches": counts, "losses": losses, "composite_losses": comp,
           "jit_losses": jit, "interpret_losses": ref, "graphs": graphs,
           "bound_args": bound,
           "ms_per_step": wall / L1_STEPS * 1e3, "card": card}
    log(f"  L1 float32 batch {L1_BATCH}: losses {losses}; composite {comp}; "
        f"launches {counts}; {res['ms_per_step']:.1f} ms/step; jit {jit} = "
        f"interpret {ref}; {graphs} graphs, {bound} arguments bound  "
        f"[{card}]")
    return res, counts


def phase_l2(card, device):
    """bench.py's long_2048_masked leg: batch 16, bf16 AMP,
    Adam(1e-4, multi_precision=True)."""
    from paddle_tpu_torch import flags

    cfg, main, loss, n_attn, scope, exe, feed = _bert_setup(
        L2_BATCH, True, SEED + 4, device)
    start = _persistables(scope, main)
    flags.set("flash_attention", "0")
    try:
        (comp_first,), _ = run_steps(exe, main, scope, feed, loss, 1)
    finally:
        flags.reset("flash_attention")
    _restore(scope, start)
    del start
    torch.cuda.empty_cache()

    cuda_sync()
    _zero_counts()
    before = graph_stats()
    reset_peak_memory()
    warm, _ = run_steps(exe, main, scope, feed, loss, L2_WARMUP)
    cuda_sync()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, L2_STEPS)
    cuda_sync()
    wall = time.perf_counter() - t0
    prof = profile_calls(
        lambda: run_steps(exe, main, scope, feed, loss, 1), L2_PROFILED,
        top=8, kernels=("flash_attention_fwd", "flash_attention_bwd_dq",
                        "flash_attention_bwd_dkv"))
    counts = _bert_counts()
    expect = _bert_expect(n_attn, L2_WARMUP + L2_STEPS + L2_PROFILED)
    if counts != expect:
        raise AssertionError(f"L2: launches {counts}, expected {expect}")
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"L2: losses {losses}")
    if abs(losses[0] - comp_first) > LOSS_RTOL_BF16 * abs(comp_first):
        raise AssertionError(f"L2: first loss {losses[0]} vs composite "
                             f"{comp_first}")
    graphs, bound = captured_graphs("L2", exe, feed)
    tokens_per_s = L2_BATCH * L_SEQ * L2_STEPS / wall   # bench.py:331
    fpt = bert_flops_per_token(cfg, L_SEQ)
    res = {"phase": "L2", "dtype": "bfloat16 AMP", "batch": L2_BATCH,
           "seq": L_SEQ, "warmup": L2_WARMUP, "steps": L2_STEPS,
           "real_tokens": _real_tokens(feed), "launches": counts,
           "losses": losses, "composite_first_loss": comp_first,
           "tokens_per_s": tokens_per_s, "ms_per_step": wall / L2_STEPS * 1e3,
           "mfu": tokens_per_s * fpt / PEAK_FLOP_PER_S[torch.bfloat16],
           "flops_per_token": fpt, "graphs": graphs, "bound_args": bound,
           "profile": prof, "card": card}
    res.update(capture_fields(before, prof, res["ms_per_step"]))
    log(f"  L2 bf16 AMP batch {L2_BATCH} x {L_SEQ}: {tokens_per_s:.1f} "
        f"tokens/s, {res['ms_per_step']:.2f} ms/step, MFU "
        f"{res['mfu']:.4f}; losses {losses}; composite first {comp_first}; "
        f"launches {counts}  [{card}]")
    log_capture("L2", res)
    log_profile(prof)
    return res, counts


def drive_bert(card, device):
    """Phase 7: BERT-base pretrained at 2048 tokens through Executor.run."""
    results, launches = [], {}
    for phase in (phase_l1, phase_l2):
        res, counts = phase(card, device)
        results.append(res)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        torch.cuda.empty_cache()
    return results, launches


# ------------------------------------------------------ ResNet-50 training


def build_resnet(use_amp, lr):
    """resnet.build(dataset="imagenet", fused_loss=True) + Momentum(lr, 0.9,
    multi_precision=use_amp), AMP cast before minimize, as bench.py builds
    its resnet50 leg."""
    from paddle_tpu_torch import (Program, amp, optimizer, program_guard,
                                  unique_name)

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = SEED
    with program_guard(main, startup), unique_name.guard():
        loss = _resnet_model()
        if use_amp:
            amp.cast_model_to_bf16(main, startup)
        _, params_grads = optimizer.Momentum(
            learning_rate=lr, momentum=0.9,
            multi_precision=use_amp).minimize(loss)
    return main, startup, loss, params_grads


def _resnet_feed(batch, seed):
    """bench.py's draws (bench.py:466-470): img randn, then label."""
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(batch, 3, R_HW, R_HW).astype(np.float32),
            "label": rng.randint(0, R_CLASSES, (batch, 1)).astype(np.int64)}


def _port_kernel_counts():
    from paddle_tpu_torch.ops.cuda import bn_relu_conv1x1 as brc

    counts = launch_counts()
    counts.update(_bert_counts())
    counts["bn_relu_conv1x1"] = brc.launches
    return counts


def phase_r1(card, device):
    """float32, batch 8: Momentum steps on the card and the same steps on
    the port's CPU path from the same weights; every forward conv runs
    with cuDNN's TF32 off."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope

    main, startup, loss, params_grads = build_resnet(False, R1_LR)
    n_conv = sum(op.type == "conv2d" for op in main.global_block().ops)
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    start = _persistables(scope, main)
    feed = _resnet_feed(R1_BATCH, SEED + 5)
    grads = [g.name for _, g in params_grads]
    seen, real_conv = [], torch.nn.functional.conv2d

    def spy(x, *args, **kw):
        seen.append((x.dtype, torch.backends.cudnn.allow_tf32))
        return real_conv(x, *args, **kw)

    torch.nn.functional.conv2d = spy
    before = graph_stats()
    try:
        cuda_sync()
        t0 = time.perf_counter()
        losses, g_card = run_steps(exe, main, scope, feed, loss, R1_STEPS,
                                   grads)
        cuda_sync()
        wall = time.perf_counter() - t0
    finally:
        torch.nn.functional.conv2d = real_conv
    # a replay runs no Python: the convs are seen in the steps that ran
    # their ops (eager warm-ups and captures), the replays run those
    gs = graph_stats(before)
    eager = gs["warmups"] + gs["captures"]
    if len(seen) != n_conv * eager or eager + gs["replays"] != R1_STEPS \
            or any(dt != torch.float32 or tf32 for dt, tf32 in seen):
        raise AssertionError(f"R1: {len(seen)} forward convs, expected "
                             f"{n_conv * eager} ({gs}), all float32 with "
                             f"cudnn.allow_tf32 off: {set(seen)}")
    cpu_scope = Scope()
    for name, value in start.items():
        cpu_scope.set_var(name, value.cpu())
    del start
    t0 = time.perf_counter()
    cpu_losses, g_cpu = run_steps(Executor(CPUPlace()), main, cpu_scope,
                                  feed, loss, R1_STEPS, grads)
    cpu_wall = time.perf_counter() - t0
    if not (np.all(np.isfinite(losses)) and np.allclose(
            losses, cpu_losses, rtol=R1_LOSS_RTOL, atol=0)):
        raise AssertionError(f"R1: card losses {losses} vs CPU {cpu_losses}")
    rel, worst, l2 = _grad_diff(grads, [g.cpu() for g in g_card], g_cpu)
    jit, ref = jit_vs_interpret("R1", exe, main, scope, feed, loss, R1_STEPS)
    graphs, bound = captured_graphs("R1", exe, feed)
    res = {"phase": "R1", "dtype": "float32", "batch": R1_BATCH,
           "steps": R1_STEPS, "lr": R1_LR, "losses": losses,
           "cpu_losses": cpu_losses, "max_rel_grad_diff": rel,
           "max_rel_grad_diff_param": worst, "l2_rel_grad_diff": l2,
           "forward_convs_tf32_off": len(seen), "jit_losses": jit,
           "interpret_losses": ref, "graphs": graphs, "bound_args": bound,
           "ms_per_step": wall / R1_STEPS * 1e3,
           "cpu_ms_per_step": cpu_wall / R1_STEPS * 1e3, "card": card}
    log(f"  R1 float32 batch {R1_BATCH}: card losses {losses}; CPU "
        f"{cpu_losses}; step-1 grads vs CPU: largest relative difference "
        f"{rel:.3e} ({worst}), L2 {l2:.3e}; {len(seen)} forward convs with "
        f"TF32 off; {res['ms_per_step']:.1f} ms/step (CPU "
        f"{res['cpu_ms_per_step']:.0f}); jit {jit} = interpret {ref}; "
        f"{graphs} graphs, {bound} arguments bound  [{card}]")
    return res


def _resnet_model():
    from paddle_tpu_torch.models import resnet

    return resnet.build(dataset="imagenet", fused_loss=True)[0]


def _f32_forward_loss(model, scope, feed):
    """The loss of a float32 forward (`model()` builds the model alone, no
    optimizer) over the same weights and batch: the bf16 parameters read
    as float32."""
    from paddle_tpu_torch import (CUDAPlace, Executor, Program, Scope,
                                  program_guard, unique_name)

    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        loss = model()
    f32 = Scope()
    for v in main.list_vars():
        if v.persistable:
            f32.set_var(v.name, scope.find_var(v.name).float())
    (out,) = Executor(CUDAPlace(0)).run(main, feed=feed, fetch_list=[loss],
                                        scope=f32, return_numpy=False)
    return float(out.float().reshape(-1)[0])


def phase_r2(card, device):
    """bench.py's resnet50 step: batch 256, bf16 AMP, Momentum(0.1, 0.9,
    multi_precision=True); no kernel of the port runs in it."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope

    main, startup, loss, _ = build_resnet(True, 0.1)
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = {k: torch.as_tensor(v, device=device)
            for k, v in _resnet_feed(R2_BATCH, 0).items()}
    ref_first = _f32_forward_loss(_resnet_model, scope, feed)
    torch.cuda.empty_cache()

    cuda_sync()
    _zero_counts()
    before = graph_stats()
    reset_peak_memory()
    warm, _ = run_steps(exe, main, scope, feed, loss, R2_WARMUP)
    cuda_sync()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, R2_STEPS)
    cuda_sync()
    wall = time.perf_counter() - t0
    prof = profile_calls(
        lambda: run_steps(exe, main, scope, feed, loss, 1), R2_PROFILED,
        top=10)
    counts = _port_kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"R2: the ResNet step launched port kernels "
                             f"{counts}")
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"R2: losses {losses}")
    if abs(losses[0] - ref_first) > LOSS_RTOL_BF16 * abs(ref_first):
        raise AssertionError(f"R2: first loss {losses[0]} vs the float32 "
                             f"forward's {ref_first}")
    graphs, bound = captured_graphs("R2", exe, feed)
    img_s = R2_BATCH * R2_STEPS / wall
    res = {"phase": "R2", "dtype": "bfloat16 AMP", "batch": R2_BATCH,
           "warmup": R2_WARMUP, "steps": R2_STEPS, "losses": losses,
           "f32_forward_first_loss": ref_first, "images_per_s": img_s,
           "ms_per_step": wall / R2_STEPS * 1e3,
           "mfu": img_s * 3.0 * RESNET50_FWD_FLOPS /
           PEAK_FLOP_PER_S[torch.bfloat16], "graphs": graphs,
           "bound_args": bound, "profile": prof, "card": card}
    res.update(capture_fields(before, prof, res["ms_per_step"]))
    log(f"  R2 bf16 AMP batch {R2_BATCH}: {img_s:.1f} img/s, "
        f"{res['ms_per_step']:.2f} ms/step, MFU {res['mfu']:.4f}; losses "
        f"{losses}; float32 forward {ref_first}  [{card}]")
    log_capture("R2", res)
    log_profile(prof)
    return res, (main, scope, exe, feed, loss)


def conv3_sites(main):
    """(batch_norm, relu, conv2d) of every bottleneck's conv3: a 1x1 conv
    reading the relu of a batch norm of a 3x3 conv (conv2)."""
    block = main.global_block()
    producer = {}
    for op in block.ops:
        for n in op.output_arg_names:
            producer.setdefault(n, op)
    sites = []
    for op in block.ops:
        if op.type != "conv2d" or tuple(
                block.var(op.input("Filter")[0]).shape[2:]) != (1, 1):
            continue
        relu = producer.get(op.input("Input")[0])
        bn = relu is not None and relu.type == "relu" and producer.get(
            relu.input("X")[0])
        conv2 = bn and bn.type == "batch_norm" and producer.get(
            bn.input("X")[0])
        if conv2 and conv2.type == "conv2d" and tuple(
                block.var(conv2.input("Filter")[0]).shape[2:]) == (3, 3):
            sites.append((bn, relu, op))
    return sites


def _bn_relu_conv(bn, relu, conv, scope, y, device):
    """The port's own batch_norm + relu + conv2d lowerings on y."""
    from paddle_tpu_torch.ops import registry

    def run(op, inputs):
        return registry.run_forward(registry.get_runtime_info(op.type),
                                    inputs, op.attrs, out_names=op.outputs,
                                    device=device)

    ins = {p: [scope.find_var(op_in) for op_in in bn.input(p)]
           for p in ("Scale", "Bias", "Mean", "Variance")}
    act = run(bn, dict(ins, X=[y]))["Y"][0]
    act = run(relu, {"X": [act]})["Out"][0]
    return run(conv, {"Input": [act], "Filter": [
        scope.find_var(conv.input("Filter")[0])]})["Output"][0]


def phase_rprobe(card, device, main, scope, exe, feed, loss):
    """Kernel #8 at the 16 conv3 sites of R2's step: each site's y (conv2's
    output), the BN's saved statistics and affine folded into scale' =
    gamma * rstd and bias' = beta - mu * scale', conv3's filter as [C, K];
    #8's output against the port's own batch_norm + relu + conv2d of that
    y."""
    from paddle_tpu_torch.ops.cuda import bn_relu_conv1x1 as brc

    sites = conv3_sites(main)
    if len(sites) != R_SITES:
        raise AssertionError(f"R/probe: {len(sites)} conv3 sites, expected "
                             f"{R_SITES}")
    fetch = [loss]
    for bn, _, _ in sites:
        fetch += [bn.input("X")[0], bn.output("SavedMean")[0],
                  bn.output("SavedVariance")[0]]
    outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                   return_numpy=False)
    cuda_sync()
    _zero_counts()
    errs, shapes = [], []
    for i, (bn, relu, conv) in enumerate(sites):
        y, mu, rstd = outs[1 + 3 * i: 4 + 3 * i]
        gamma = scope.find_var(bn.input("Scale")[0]).float()
        beta = scope.find_var(bn.input("Bias")[0]).float()
        s_ = (gamma * rstd.float()).contiguous()
        b_ = (beta - mu.float() * s_).contiguous()
        filt = scope.find_var(conv.input("Filter")[0])
        w = filt.reshape(filt.shape[0], filt.shape[1]).t().contiguous()
        z = brc.bn_relu_conv1x1(y.contiguous(), s_, b_, w)
        ref = _bn_relu_conv(bn, relu, conv, scope, y, device)
        cuda_sync()
        errs.append(_conv1x1_err(z, ref, torch.bfloat16, False))
        shapes.append(f"{tuple(y.shape)}->{filt.shape[0]}")
        del z, ref
    launches = brc.launches
    if launches != R_SITES:
        raise AssertionError(f"R/probe: {launches} #8 launches, expected "
                             f"{R_SITES}")
    if not max(errs) <= BF16_TOL:
        raise AssertionError(f"R/probe: #8 vs batch_norm + relu + conv2d: "
                             f"errors {errs} > {BF16_TOL}")
    res = {"phase": "R/probe", "sites": R_SITES, "launches": launches,
           "max_rel_err": max(errs), "errs": errs, "shapes": shapes,
           "card": card}
    log(f"  R/probe: {R_SITES} conv3 sites of R2's step, #8 vs the port's "
        f"batch_norm + relu + conv2d: largest error {max(errs):.2e} of the "
        f"output's largest magnitude; {launches} launches  [{card}]")
    return res, launches


def drive_resnet(card, device):
    """Phase 8: ResNet-50 trained through Executor.run (R1, R2), kernel #8
    on R2's conv3 sites (R/probe), then the conv1x1 probe."""
    from paddle_tpu_torch.ops.cuda import bn_relu_conv1x1 as brc
    from paddle_tpu_torch.tools import conv1x1_fuse_probe

    results = [phase_r1(card, device)]
    torch.cuda.empty_cache()
    res, state = phase_r2(card, device)
    results.append(res)
    res, site_launches = phase_rprobe(card, device, *state)
    results.append(res)
    del state
    torch.cuda.empty_cache()
    log(f"  conv1x1 probe (python -m paddle_tpu_torch.tools."
        f"conv1x1_fuse_probe) [{card}]")
    _zero_counts()
    probe = conv1x1_fuse_probe.main(["--reps", "10"])
    probe_launches = brc.launches
    results.append({"phase": "R/conv1x1_probe", "launches": probe_launches,
                    "shapes": probe, "card": card})
    torch.cuda.empty_cache()
    return results, {"bn_relu_conv1x1": site_launches + probe_launches}


# ------------------------------------------------- image training ([9])


def build_image(leg, use_amp):
    """IMAGE_LEGS[leg]'s model + Momentum(0.01, 0.9,
    multi_precision=use_amp), random_seed 1, AMP cast before minimize, as
    bench.py's _setup builds its image legs."""
    import importlib

    from paddle_tpu_torch import (Program, amp, optimizer, program_guard,
                                  unique_name)

    cfg = IMAGE_LEGS[leg]
    build = getattr(importlib.import_module(
        f"paddle_tpu_torch.models.{cfg.module}"), cfg.builder)
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 1
    with program_guard(main, startup), unique_name.guard():
        loss, prediction, _ = build(**cfg.kwargs)
        if use_amp:
            amp.cast_model_to_bf16(main, startup)
        optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                           multi_precision=use_amp).minimize(loss)
    return main, startup, loss, prediction


def _image_feed(leg, batch):
    """bench.py's draws (bench.py:530-536): RandomState(0), img randn,
    then label."""
    cfg = IMAGE_LEGS[leg]
    rng = np.random.RandomState(0)
    return {"img": rng.randn(batch, *cfg.image).astype(np.float32),
            "label": rng.randint(0, cfg.classes, (batch, 1)).astype(
                np.int64)}


def _image_f32_check(leg):
    """The float32 `clone(for_test=True)` forward at the leg's check batch
    on the card and on the port's CPU path, from the same weights: the
    loss, and the logits (the softmax's input: a saturated softmax leaves
    the loss at cross_entropy's clip) within IMG_RTOL of their largest
    magnitude.  -> (card loss, CPU loss, the logits' error)."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope

    main, startup, loss, prediction = build_image(leg, False)
    test = main.clone(for_test=True)
    fetch = [loss.name, _softmax_input(test, prediction)]
    scope = Scope()
    Executor(CUDAPlace(0)).run(startup, scope=scope)
    feed = _image_feed(leg, IMAGE_LEGS[leg].check_batch)
    on_card = Executor(CUDAPlace(0)).run(test, feed=feed, fetch_list=fetch,
                                         scope=scope)
    cpu_scope = Scope()
    for name, value in _persistables(scope, test).items():
        cpu_scope.set_var(name, value.cpu())
    on_cpu = Executor(CPUPlace()).run(test, feed=feed, fetch_list=fetch,
                                      scope=cpu_scope)
    logits_err = _rel_err(on_card[1], on_cpu[1])
    card_loss, cpu_loss = float(on_card[0].ravel()[0]), float(
        on_cpu[0].ravel()[0])
    if not (np.isfinite(card_loss) and abs(card_loss - cpu_loss)
            <= IMG_RTOL * abs(cpu_loss) and logits_err <= IMG_RTOL):
        raise AssertionError(f"{leg}: float32 test loss on the card "
                             f"{card_loss} vs the CPU's {cpu_loss}, logits "
                             f"{logits_err:.2e} apart")
    return card_loss, cpu_loss, logits_err


def phase_image(leg, card, device):
    """One of bench.py's image legs (IMAGE_LEGS), bf16 AMP, captured; no
    kernel of the port runs in it.  Then the float32 test forward, card
    vs CPU."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope
    from paddle_tpu_torch.framework.core_types import dtype_to_torch

    cfg = IMAGE_LEGS[leg]
    batch = cfg.batch
    main, startup, loss, _ = build_image(leg, True)
    ops = [op.type for op in main.global_block().ops]
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    block = main.global_block()
    # staged on the card once, in the declared dtypes (img is bf16 under
    # AMP, as bench.py casts it)
    feed = {k: torch.as_tensor(v, device=device).to(
                dtype_to_torch(block.var(k).dtype))
            for k, v in _image_feed(leg, batch).items()}

    cuda_sync()
    _zero_counts()
    before = graph_stats()
    reset_peak_memory()
    warm, _ = run_steps(exe, main, scope, feed, loss, IMG_WARMUP)
    cuda_sync()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, IMG_STEPS)
    cuda_sync()
    wall = time.perf_counter() - t0
    prof = profile_calls(
        lambda: run_steps(exe, main, scope, feed, loss, 1), IMG_PROFILED,
        top=10, classes=KERNEL_CLASSES)
    counts = _port_kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"{leg}: the step launched port kernels "
                             f"{counts}")
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{leg}: losses {losses}")
    graphs, bound = captured_graphs(leg, exe, feed)
    res = {"phase": leg, "model": cfg.module, "dtype": "bfloat16 AMP",
           "batch": batch, "image": list(cfg.image), "warmup": IMG_WARMUP,
           "steps": IMG_STEPS,
           "convs": {t: ops.count(t) for t in ("conv2d", "depthwise_conv2d")},
           "dropouts": ops.count("dropout"), "losses": losses,
           "images_per_s": batch * IMG_STEPS / wall,
           "ms_per_step": wall / IMG_STEPS * 1e3,
           "reference_images_per_s": cfg.reference, "graphs": graphs,
           "bound_args": bound, "profile": prof, "card": card}
    res.update(capture_fields(before, prof, res["ms_per_step"]))
    del scope, exe, feed
    torch.cuda.empty_cache()
    (res["f32_test_loss"], res["f32_test_loss_cpu"],
     res["f32_test_logits_rel_err"]) = _image_f32_check(leg)
    ref = (f"; the reference's published {cfg.reference:.1f} img/s (K40m) "
           f"beside" if cfg.reference else "")
    log(f"  {leg} ({res['model']}) bf16 AMP batch {batch}: "
        f"{res['images_per_s']:.1f} img/s, {res['ms_per_step']:.2f} ms/step"
        f"{ref}; losses {losses}; float32 test forward at batch "
        f"{cfg.check_batch}: card {res['f32_test_loss']}, CPU "
        f"{res['f32_test_loss_cpu']}, logits "
        f"{res['f32_test_logits_rel_err']:.2e} apart; {graphs} graphs, "
        f"{bound} arguments "
        f"bound  [{card}]")
    log_capture(leg, res)
    log_profile(prof)
    return res


def phase_book(card, device):
    """B/book: the book's main programs as the JAX package dumped them
    (explicit grad and optimizer ops), from the port's own startup on the
    card: BOOK_STEPS steps on the card (jit: warm-up, capture, replay)
    and the same steps on the port's CPU path from the same weights,
    losses within BOOK_RTOL; no port kernel."""
    import pathlib

    from paddle_tpu_torch import (CPUPlace, CUDAPlace, Executor, Program,
                                  Scope)

    book = pathlib.Path(__file__).resolve().parent / "tests" / "book" / \
        "_programs"
    res = {"phase": "B/book", "batch": BOOK_BATCH, "steps": BOOK_STEPS,
           "programs": {}, "card": card}
    _zero_counts()
    for name, (loss, make_feed) in BOOK_PROGRAMS.items():
        main = Program.from_dict(json.loads(
            (book / f"{name}.main.json").read_text()))
        startup = Program.from_dict(json.loads(
            (book / f"{name}.startup.json").read_text()))
        scope, exe = Scope(), Executor(CUDAPlace(0))
        exe.run(startup, scope=scope)
        cpu_scope = Scope()
        for n, value in _persistables(scope, main).items():
            cpu_scope.set_var(n, value.cpu())
        feed = make_feed(np.random.RandomState(SEED), BOOK_BATCH)
        before = graph_stats()
        losses, _ = run_steps(exe, main, scope, feed, loss, BOOK_STEPS)
        gs = graph_stats(before)
        cpu_losses, _ = run_steps(Executor(CPUPlace()), main, cpu_scope,
                                  feed, loss, BOOK_STEPS)
        if not (np.all(np.isfinite(losses)) and np.allclose(
                losses, cpu_losses, rtol=BOOK_RTOL, atol=0)):
            raise AssertionError(f"B/book {name}: card losses {losses} vs "
                                 f"CPU {cpu_losses}")
        graphs, bound = captured_graphs(f"B/book {name}", exe, feed)
        res["programs"][name] = {
            "ops": len(main.global_block().ops), "losses": losses,
            "cpu_losses": cpu_losses, "graphs": graphs, "bound_args": bound,
            "captures": gs["captures"], "replays": gs["replays"]}
        log(f"  B/book {name}: {len(main.global_block().ops)} ops, card "
            f"losses {losses}, CPU {cpu_losses}; {gs['captures']} captured, "
            f"{gs['replays']} replayed, {bound} arguments bound  [{card}]")
    counts = _port_kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"B/book: launched port kernels {counts}")
    return res


def drive_images(card, device, lap=lambda phase: None):
    """Phase 9: bench.py's five image legs, then the book's main
    programs; `lap(phase)` after each."""
    results = []
    for leg in IMAGE_LEGS:
        results.append(phase_image(leg, card, device))
        torch.cuda.empty_cache()
        lap(f"[9] {leg}")
    results.append(phase_book(card, device))
    lap("[9] B/book")
    return results


# ----------------------------------------- the recurrent family (SL, MT)


def _sl_model(**kw):
    from paddle_tpu_torch.models import stacked_lstm

    return stacked_lstm.build(seq_len=SL_SEQ, hidden_dim=SL_HIDDEN,
                              stacked_num=SL_LAYERS, **kw)[0]


def _mt_model(**kw):
    from paddle_tpu_torch.models import machine_translation as mt

    return mt.build(src_seq_len=MT_SRC, trg_seq_len=MT_SRC,
                    dict_size=MT_DICT, emb_dim=MT_EMB, hidden_dim=MT_HIDDEN,
                    **kw)[0]


RNN_MODELS = {"SL": _sl_model, "MT": _mt_model}


def build_rnn(model, use_amp):
    """bench.py's _setup (bench.py:186-202) for its stacked_lstm and
    machine_translation legs: random_seed 1, the AMP cast before
    minimize, Adam(1e-3, multi_precision=use_amp)."""
    from paddle_tpu_torch import (Program, amp, optimizer, program_guard,
                                  unique_name)

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 1
    with program_guard(main, startup), unique_name.guard():
        loss = RNN_MODELS[model]()
        if use_amp:
            amp.cast_model_to_bf16(main, startup)
        optimizer.Adam(learning_rate=1e-3,
                       multi_precision=use_amp).minimize(loss)
    return main, startup, loss


def rnn_feeds(model, batch):
    """bench.py's draws: stacked_lstm's 8-batch cycle (4 word batches,
    each twice, labels drawn independently; bench.py:573-584), the
    translator's one batch over its feed_shapes (bench.py:836-840)."""
    from paddle_tpu_torch.models import machine_translation as mt

    rng = np.random.RandomState(0)
    if model == "SL":
        words4 = rng.randint(0, SL_DICT, (4, batch, SL_SEQ)).astype(np.int64)
        words = np.concatenate([words4, words4], axis=0)
        labels = rng.randint(0, 2, (8, batch, 1)).astype(np.int64)
        return [{"words": w, "label": lb} for w, lb in zip(words, labels)]
    return [{name: rng.randint(0, MT_DICT, shape).astype(dtype)
             for name, (shape, dtype) in mt.feed_shapes(
                 batch, MT_SRC, MT_SRC).items()}]


def run_feeds(exe, main, scope, feeds, loss, n, start=0):
    """n training steps, step i on feeds[(start + i) % len(feeds)]."""
    losses = []
    for i in range(n):
        losses += run_steps(exe, main, scope,
                            feeds[(start + i) % len(feeds)], loss, 1)[0]
    return losses


def phase_rnn1(model, card, device):
    """SL1 / MT1, float32 at bench.py's widths: RNN1_STEPS Adam steps on
    the card and the same steps on the port's CPU path from the same
    weights (losses within RNN_LOSS_RTOL, TF32 off); then each step run by
    the interpreter and by the captured graph from the same state.
    Returns (result, the card scope)."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope
    from paddle_tpu_torch.ops import attention_ops

    phase = f"{model}1"
    batch = SL1_BATCH if model == "SL" else MT1_BATCH
    main, startup, loss = build_rnn(model, False)
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    start = _persistables(scope, main)
    feeds = rnn_feeds(model, batch)
    card_feeds = [{k: torch.as_tensor(v, device=device) for k, v in f.items()}
                  for f in feeds]
    attention_ops.TIER_CALLS.clear()
    _zero_counts()
    cuda_sync()
    t0 = time.perf_counter()
    losses = run_feeds(exe, main, scope, card_feeds, loss, RNN1_STEPS)
    cuda_sync()
    wall = time.perf_counter() - t0
    tiers = dict(attention_ops.TIER_CALLS)
    counts = _port_kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"{phase}: launched port kernels {counts}")
    cpu_scope = Scope()
    for name, value in start.items():
        cpu_scope.set_var(name, value.cpu())
    del start
    t0 = time.perf_counter()
    cpu_losses = run_feeds(Executor(CPUPlace()), main, cpu_scope, feeds,
                           loss, RNN1_STEPS)
    cpu_wall = time.perf_counter() - t0
    del cpu_scope
    if not (np.all(np.isfinite(losses)) and np.allclose(
            losses, cpu_losses, rtol=RNN_LOSS_RTOL, atol=0)):
        raise AssertionError(f"{phase}: card losses {losses} vs CPU "
                             f"{cpu_losses}")
    jit, ref = jit_vs_interpret(phase, exe, main, scope, card_feeds[0], loss,
                                RNN1_STEPS)
    graphs, bound = captured_graphs(phase, exe, card_feeds[0])
    res = {"phase": phase, "dtype": "float32", "batch": batch,
           "steps": RNN1_STEPS, "losses": losses, "cpu_losses": cpu_losses,
           "jit_losses": jit, "interpret_losses": ref,
           "attention_tiers": tiers, "graphs": graphs, "bound_args": bound,
           "ms_per_step": wall / RNN1_STEPS * 1e3,
           "cpu_ms_per_step": cpu_wall / RNN1_STEPS * 1e3, "card": card}
    log(f"  {phase} float32 batch {batch}: card losses {losses}; CPU "
        f"{cpu_losses}; jit {jit} = interpret {ref}; attention tiers "
        f"{tiers}; {res['ms_per_step']:.1f} ms/step (CPU "
        f"{res['cpu_ms_per_step']:.0f}); {graphs} graphs, {bound} arguments "
        f"bound  [{card}]")
    return res, scope


def lstm_time_split(main, scope, feed, loss):
    """The card's time in the recurrent ops over one step run by the
    interpreter from a copy of the state, under torch.profiler: the
    forward loops, the grad's replay of them under autograd, and its
    backward (the grad op's time less the replay), in ms and as shares
    of the step's busy time.  A captured step runs no Python, so the
    split is taken where the ops run one by one: the same kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch import CUDAPlace, Executor, Scope
    from paddle_tpu_torch.ops import registry

    fwd = registry.OPS["fused_lstm"]
    grad = registry.get_runtime_info("fused_lstm_grad")
    real_fwd, real_grad = fwd.forward, grad.forward

    def labelled(fn, label):
        def run(ctx):
            cuda_sync()
            with record_function(label(ctx)):
                fn(ctx)
                cuda_sync()
        return run

    fwd.forward = labelled(real_fwd, lambda ctx: "lstm replay"
                           if torch.is_grad_enabled() else "lstm forward")
    grad.forward = labelled(real_grad, lambda ctx: "lstm grad")
    scratch = Scope()
    for name, value in _persistables(scope, main).items():
        scratch.set_var(name, value)
    eager = Executor(CUDAPlace(0), mode="interpret")
    try:
        run_steps(eager, main, scratch, feed, loss, 1)   # warm-up
        cuda_sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_steps(eager, main, scratch, feed, loss, 1)
            cuda_sync()
    finally:
        fwd.forward, grad.forward = real_fwd, real_grad
        del scratch
        torch.cuda.empty_cache()
    labels = ("lstm forward", "lstm replay", "lstm grad")
    spans = [sp for sp in device_spans(prof) if sp[0] not in labels]
    if not spans:
        return None   # the profiler saw no device activity
    busy = busy_us(spans)
    ms = {}
    for label in labels:
        ranges = [(e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name == label]
        ms[label] = busy_us([sp for sp in spans
                             if any(a <= sp[1] < b for a, b in ranges)]) / 1e3
    split = {"forward_ms": ms["lstm forward"],
             "replay_ms": ms["lstm replay"],
             "backward_ms": ms["lstm grad"] - ms["lstm replay"],
             "step_busy_ms": busy / 1e3}
    for k in ("forward", "replay", "backward"):
        split[f"{k}_share"] = split[f"{k}_ms"] / split["step_busy_ms"]
    return split


def phase_rnn2(model, card, device):
    """SL2 / MT2, bench.py's leg: bf16 AMP, Adam(1e-3, multi_precision),
    its feeds staged on the card (SL's 8-batch cycle: warm-up, timed and
    profiled steps walk it in order) on the jit path: RNN2_WARMUP warm-up
    (eager, capture), RNN2_STEPS timed and RNN2_PROFILED profiled steps;
    examples/s, ms per step, card busy and idle share, graphs, capture
    seconds, graph-pool MiB, peak memory; the first loss within 2e-2 of a
    float32 forward of the same weights and batch; no port kernel."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope

    phase = f"{model}2"
    batch = SL2_BATCH if model == "SL" else MT2_BATCH
    main, startup, loss = build_rnn(model, True)
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    feeds = [{k: torch.as_tensor(v, device=device) for k, v in f.items()}
             for f in rnn_feeds(model, batch)]
    ref_first = _f32_forward_loss(RNN_MODELS[model], scope, feeds[0])
    torch.cuda.empty_cache()

    cuda_sync()
    _zero_counts()
    before = graph_stats()
    reset_peak_memory()
    warm = run_feeds(exe, main, scope, feeds, loss, RNN2_WARMUP)
    cuda_sync()
    t0 = time.perf_counter()
    timed = run_feeds(exe, main, scope, feeds, loss, RNN2_STEPS,
                      start=RNN2_WARMUP)
    cuda_sync()
    wall = time.perf_counter() - t0
    nxt = feeds[(RNN2_WARMUP + RNN2_STEPS) % len(feeds)]
    prof = profile_calls(
        lambda: run_steps(exe, main, scope, nxt, loss, 1), RNN2_PROFILED,
        top=10)
    counts = _port_kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"{phase}: launched port kernels {counts}")
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: losses {losses}")
    if abs(losses[0] - ref_first) > LOSS_RTOL_BF16 * abs(ref_first):
        raise AssertionError(f"{phase}: first loss {losses[0]} vs the "
                             f"float32 forward's {ref_first}")
    graphs, bound = captured_graphs(phase, exe, feeds[0])
    res = {"phase": phase, "dtype": "bfloat16 AMP", "batch": batch,
           "warmup": RNN2_WARMUP, "steps": RNN2_STEPS, "losses": losses,
           "f32_forward_first_loss": ref_first,
           "examples_per_s": batch * RNN2_STEPS / wall,
           "ms_per_step": wall / RNN2_STEPS * 1e3, "graphs": graphs,
           "bound_args": bound, "profile": prof, "card": card}
    res.update(capture_fields(before, prof, res["ms_per_step"]))
    if model == "SL":
        res["lstm_split"] = lstm_time_split(main, scope, feeds[0], loss)
    log(f"  {phase} bf16 AMP batch {batch}: {res['examples_per_s']:.1f} "
        f"examples/s, {res['ms_per_step']:.2f} ms/step; losses {losses}; "
        f"float32 forward {ref_first}  [{card}]")
    if model == "SL":
        log(f"    the LSTM loops in an interpreted step's card time: "
            f"{res['lstm_split']}")
        log(f"  the reference: {SL_K40M_MS:.0f} ms/batch of 64, "
            f"{64 / SL_K40M_MS * 1e3:.1f} examples/s on a Tesla K40m "
            f"(benchmark/README.md:112-119, bench.py:555-556), a point of "
            f"comparison, not a yardstick")
    log_capture(phase, res)
    log_profile(prof)
    del scope, exe, feeds
    torch.cuda.empty_cache()
    return res


def phase_mt_decode(card, device, train_scope):
    """MT/decode: build_decode at MT1's widths (float32), MT1's trained
    weights carried into a fresh scope, 8 source rows.  Step t's
    teacher-forced logits equal the train program's at t within
    TF_LOGITS_TOL; greedy (NEW_TOKENS) equals mode="interpret"; beam 1
    equals greedy; beam BEAM_K on the captured step gives the interpreted
    search's tokens, scores within BEAM_TOL; every step's attention (one
    head of 256 over 24 keys) is one #6 launch."""
    from paddle_tpu_torch import (CUDAPlace, Executor, Program, Scope,
                                  decode, program_guard, unique_name)
    from paddle_tpu_torch.models import machine_translation as mt

    spec = mt.build_decode(src_seq_len=MT_SRC, dict_size=MT_DICT,
                           emb_dim=MT_EMB, hidden_dim=MT_HIDDEN)
    progs = [spec.prefill_program, spec.step_program]
    scope = Scope()
    for p in progs:
        for v in p.list_vars():
            if v.persistable:
                scope.set_var(v.name, train_scope.find_var(v.name).clone())
    feed = rnn_feeds("MT", MT_DEC_BATCH)[0]
    src = {"src_ids": feed["src_ids"]}
    place = CUDAPlace(0)

    # the train program's logits on the same weights (no optimizer)
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        _, logits = mt.build(src_seq_len=MT_SRC, trg_seq_len=MT_SRC,
                             dict_size=MT_DICT, emb_dim=MT_EMB,
                             hidden_dim=MT_HIDDEN)
    (ref,) = Executor(place).run(main, feed=feed, fetch_list=[logits],
                                 scope=scope, return_numpy=False)
    gen = decode.Generator(spec, scope=scope, place=place)
    with torch.inference_mode():
        _, states, lengths, pl = gen._prefill(src)
        tf_err = 0.0
        for t in range(MT_SRC):
            lg, states = gen._step(feed["trg_ids"][:, t], lengths, states, {})
            tf_err = max(tf_err, (lg - ref[:, t]).abs().max().item())
    if pl is not None or not tf_err <= TF_LOGITS_TOL:
        raise AssertionError(f"MT/decode: teacher-forced steps vs the train "
                             f"logits {tf_err}")
    del ref

    gen.generate(src, 2, eos_id=-1)   # warm-up at the counted signatures
    gen.generate(src, 2, method="beam", beam_size=BEAM_K, eos_id=-1)
    expect = dict.fromkeys(SERVING_KERNELS, 0)
    expect["flash_decode"] = NEW_TOKENS
    cuda_sync()
    reset_peak_memory()
    _zero_counts()
    g0 = graph_stats()
    t0 = time.perf_counter()
    greedy = gen.generate(src, NEW_TOKENS, eos_id=-1)
    cuda_sync()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if counts != expect or greedy.shape != (MT_DEC_BATCH, NEW_TOKENS):
        raise AssertionError(f"MT/decode greedy: launches {counts}, "
                             f"expected {expect}; tokens {greedy.shape}")
    _zero_counts()
    t0 = time.perf_counter()
    tokens, scores = gen.generate(src, NEW_TOKENS, method="beam",
                                  beam_size=BEAM_K, eos_id=-1)
    cuda_sync()
    beam_wall = time.perf_counter() - t0
    beam_counts = launch_counts()
    if beam_counts != expect:
        raise AssertionError(f"MT/decode beam: launches {beam_counts}, "
                             f"expected {expect}")
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated()
    one, _ = gen.generate(src, NEW_TOKENS, method="beam", beam_size=1,
                          eos_id=-1)
    eager = decode.Generator(spec, scope=scope, place=place,
                             mode="interpret")
    e_greedy = eager.generate(src, NEW_TOKENS, eos_id=-1)
    e_tokens, e_scores = eager.generate(src, NEW_TOKENS, method="beam",
                                        beam_size=BEAM_K, eos_id=-1)
    err = float(np.abs(scores - e_scores).max())
    if not (np.array_equal(greedy, e_greedy)
            and np.array_equal(one[:, 0], greedy)
            and np.array_equal(tokens, e_tokens) and err <= BEAM_TOL
            and (np.diff(scores, axis=1) <= 0).all()):
        raise AssertionError(
            f"MT/decode: greedy = interpret {np.array_equal(greedy, e_greedy)}"
            f", beam 1 = greedy {np.array_equal(one[:, 0], greedy)}, beam "
            f"tokens = interpret {np.array_equal(tokens, e_tokens)}, scores "
            f"{err}")
    with torch.inference_mode():
        _, states, lengths, _ = gen._prefill(src)
        prof = profile_decode_steps(
            gen, {}, np.full(MT_DEC_BATCH, spec.bos_id), lengths, states, 8,
            kernels=("flash_decode",))
    res = {"phase": "MT/decode", "batch": MT_DEC_BATCH, "src_len": MT_SRC,
           "hidden": MT_HIDDEN, "new_tokens": NEW_TOKENS,
           "teacher_forced_max_abs_err": tf_err,
           "greedy_s": wall, "tokens_per_s": MT_DEC_BATCH * NEW_TOKENS / wall,
           "host_ms_per_step": wall / NEW_TOKENS * 1e3,
           "card_busy_ms_per_step": prof["busy_ms_per_step"] if prof else None,
           "beam_s": beam_wall,
           "beam_tokens_per_s": MT_DEC_BATCH * NEW_TOKENS / beam_wall,
           "beam_scores_max_abs_diff_vs_interpret": err,
           "launches": counts, "beam_launches": beam_counts,
           "graphs": graphs, "peak_mem_mib": peak / 2 ** 20,
           "profile": prof, "card": card}
    log(f"  MT/decode float32 batch {MT_DEC_BATCH}: teacher-forced steps vs "
        f"the train logits {tf_err:.2e}; greedy {NEW_TOKENS} tokens in "
        f"{wall:.3f} s ({res['tokens_per_s']:.1f} tokens/s, "
        f"{res['host_ms_per_step']:.3f} host ms/step, card "
        f"{res['card_busy_ms_per_step']} ms/step) = interpret; beam 1 = "
        f"greedy; beam {BEAM_K} ({MT_DEC_BATCH * BEAM_K} rows) "
        f"{beam_wall:.3f} s, tokens = interpret, scores {err}; launches "
        f"{counts} and {beam_counts}; CUDA graphs {graphs}; peak "
        f"{res['peak_mem_mib']:.0f} MiB  [{card}]")
    log_profile(prof)
    return res, {"flash_decode": counts["flash_decode"]
                 + beam_counts["flash_decode"]}


def drive_rnn(card, device, lap=lambda phase: None):
    """Phase 10: the stacked LSTM (SL1, SL2) and the GRU translator (MT1,
    MT2, MT/decode); `lap(phase)` after each."""
    results = []
    res, scope = phase_rnn1("SL", card, device)
    results.append(res)
    del scope
    torch.cuda.empty_cache()
    lap("[10] SL1")
    results.append(phase_rnn2("SL", card, device))
    lap("[10] SL2")
    res, mt_scope = phase_rnn1("MT", card, device)
    results.append(res)
    torch.cuda.empty_cache()
    lap("[10] MT1")
    results.append(phase_rnn2("MT", card, device))
    lap("[10] MT2")
    res, launches = phase_mt_decode(card, device, mt_scope)
    results.append(res)
    del mt_scope
    torch.cuda.empty_cache()
    lap("[10] MT/decode")
    return results, launches


# ------------------------------------------- serving a saved model (I)

# phase I/infer: bench.py's infer leg (bench.py:671-813): each model built
# with random_seed 1, clone(for_test=True), the InferenceTranspiler's
# passes, _prune to the main prediction, batch 16 of 3x224x224 float32
# images from RandomState(0); the reference's published bs=16 rates on a 2S
# Xeon 6148 (bench.py:600-605, BASELINE.md:34-37), a CPU reference
INFER_PUBLISHED = {"resnet50": 217.69, "googlenet": 600.94,
                   "alexnet": 850.51, "vgg19": 96.75}
I_BATCH, I_WARMUP, I_STEPS, I_PROFILED = 16, 2, 20, 1
I_CPU_BATCH = 2               # check (c): the CPU Predictor's batch
I_CLONES, I_CLONE_RUNS = 4, 3  # check (d), on ResNet-50's Predictor
I_FOLD_TOL = 1e-4             # (a) transpiled vs not, of the largest logit
I_SAVED_TOL = 1e-6            # (b) the saved model's Predictor vs (a)
I_CPU_TOL = 1e-3              # (c) card vs CPU (PERF.md's cuDNN vs CPU)
I_CLONE_RTOL, I_CLONE_ATOL = 1e-6, 1e-7   # (d), tests/test_inference.py's


def _saved_dir(name):
    """A fresh directory inside the checkout's ignored build/ tree, for a
    saved model, a checkpoint or shard servers' ready files."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke_saved", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def build_infer_model(name):
    """bench.py's build_model (bench.py:691-711): (main, startup,
    prediction), the main prediction head, random_seed 1."""
    from paddle_tpu_torch import Program, program_guard, unique_name
    from paddle_tpu_torch.models import alexnet, googlenet, resnet, vgg

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 1
    with program_guard(main, startup), unique_name.guard():
        if name == "resnet50":
            built = resnet.build(dataset="imagenet")
        elif name == "vgg19":
            built = vgg.build(image_shape=(3, R_HW, R_HW), class_dim=1000,
                              depth=19)
        else:
            built = {"googlenet": googlenet, "alexnet": alexnet}[name].build()
    return main, startup, built[1]


def _softmax_input(program, prediction):
    """The fc output that feeds the prediction's softmax."""
    for op in program.global_block().ops:
        if op.type == "softmax" and op.outputs["Out"] == [prediction.name]:
            return op.inputs["X"][0]
    raise AssertionError(f"no softmax writes {prediction.name}")


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def time_forwards(fn, warmup, steps, profiled):
    """`warmup` calls, then `steps` timed ones (host clock, synchronised),
    then `profiled` under torch.profiler: (host ms per call, profile)."""
    for _ in range(warmup):
        fn()
    cuda_sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    cuda_sync()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    return host_ms, profile_calls(fn, profiled, top=5)


def _clone_runs(clones, feeds, runs):
    """Clone t runs feeds[t * runs:(t + 1) * runs] in its own thread, all
    started together: (outputs in feed order, wall seconds)."""
    outs, errors = [None] * len(feeds), []
    barrier = threading.Barrier(len(clones))

    def worker(t, p):
        try:
            barrier.wait(timeout=120)
            for i in range(t * runs, (t + 1) * runs):
                outs[i] = p.run(feeds[i])[0]
        except Exception as e:  # noqa: BLE001  (re-raised after join)
            errors.append((t, e))

    threads = [threading.Thread(target=worker, args=(t, p))
               for t, p in enumerate(clones)]
    cuda_sync()
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"I/infer clones: {errors or 'a thread hung'}")
    return outs, wall


def check_clones(pred, card):
    """(d): I_CLONES clones of `pred` in as many threads, I_CLONE_RUNS runs
    each (a warm-up, a capture, a replay, while the others run), against
    `pred`'s sequential run of the same feeds; then a second round of the
    same clones, every call a replay, timed beside `pred` running the same
    feeds alone."""
    rng = np.random.RandomState(1)
    feeds = [{"img": rng.randn(I_BATCH, 3, R_HW, R_HW).astype(np.float32)}
             for _ in range(I_CLONES * I_CLONE_RUNS)]
    sequential = [pred.run(f)[0] for f in feeds]
    clones = [pred.clone() for _ in range(I_CLONES)]
    g0 = graph_stats()
    first, first_wall = _clone_runs(clones, feeds, I_CLONE_RUNS)
    graphs = graph_stats(g0)
    again, clones_wall = _clone_runs(clones, feeds, I_CLONE_RUNS)
    t0 = time.perf_counter()
    for f in feeds:
        pred.run(f)
    alone_wall = time.perf_counter() - t0
    err = 0.0
    for got, want in zip(first + again, sequential + sequential):
        if not np.allclose(got, want, rtol=I_CLONE_RTOL, atol=I_CLONE_ATOL):
            raise AssertionError(f"I/infer (d): a clone's output differs from "
                                 f"the sequential run by "
                                 f"{np.abs(got - want).max()}")
        err = max(err, float(np.abs(got - want).max()))
    n_img = len(feeds) * I_BATCH
    res = {"clones": I_CLONES, "runs_each": I_CLONE_RUNS,
           "max_abs_diff_vs_sequential": err, "graphs_first_round": graphs,
           "first_round_img_per_s": n_img / first_wall,
           "clones_img_per_s": n_img / clones_wall,
           "one_predictor_img_per_s": n_img / alone_wall}
    log(f"    (d) {I_CLONES} clones x {I_CLONE_RUNS} runs in threads = the "
        f"sequential run (max abs {err:.2e}); first round (warm-up, capture,"
        f" replay) {res['first_round_img_per_s']:.1f} img/s, graphs "
        f"{graphs}; replays: clones {res['clones_img_per_s']:.1f} img/s vs "
        f"one predictor {res['one_predictor_img_per_s']:.1f} img/s  [{card}]")
    return res


def phase_infer_model(name, card):
    """One model of bench.py's infer leg on the card, with checks (a)-(d)
    ((d) for ResNet-50 only)."""
    from paddle_tpu_torch import (CPUPlace, CUDAPlace, Executor, Scope, io,
                                  scope_guard)
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.transpiler import InferenceTranspiler

    place = CUDAPlace(0)
    main, startup, prediction = build_infer_model(name)
    infer = main.clone(for_test=True)
    logits = _softmax_input(infer, prediction)
    fetch = [logits, prediction.name]
    scope, exe = Scope(), Executor(place)
    exe.run(startup, scope=scope)
    saved = _saved_dir(name)
    with scope_guard(scope):
        io.save_inference_model(saved, ["img"], [prediction], exe,
                                main_program=main)
    rng = np.random.RandomState(0)
    images = rng.randn(I_BATCH, 3, R_HW, R_HW).astype(np.float32)
    feed = {"img": torch.as_tensor(images, device=place.device)}

    # the same forward without the transpiler
    plain = infer._prune([prediction])
    plain_exe = Executor(place)

    def plain_fwd():
        return plain_exe.run(plain, feed=feed, fetch_list=fetch, scope=scope,
                             return_numpy=False)

    plain_out = [t.cpu().numpy() for t in plain_fwd()]
    plain_ms, plain_prof = time_forwards(plain_fwd, I_WARMUP, I_STEPS,
                                         I_PROFILED)
    del plain_exe
    torch.cuda.empty_cache()

    # bench.py's order: transpile, then prune
    InferenceTranspiler().transpile(infer, scope=scope)
    infer = infer._prune([prediction])
    types = [op.type for op in infer.global_block().ops]
    t_exe = Executor(place)

    def fwd():
        return t_exe.run(infer, feed=feed, fetch_list=fetch, scope=scope,
                         return_numpy=False)

    cuda_sync()
    _zero_counts()
    reset_peak_memory()
    g0 = graph_stats()
    host_ms, prof = time_forwards(fwd, I_WARMUP, I_STEPS, I_PROFILED)
    graphs = graph_stats(g0)
    peak = (torch.cuda.max_memory_allocated() / 2 ** 20,
            torch.cuda.max_memory_reserved() / 2 ** 20)
    counts = _port_kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"I/infer {name}: port kernels launched {counts}")
    out = [t.cpu().numpy() for t in fwd()]
    if not all(np.isfinite(o).all() for o in out) or \
            out[1].shape != (I_BATCH, 1000):
        raise AssertionError(f"I/infer {name}: outputs {out[1].shape}")

    # (a) the fold and fuses change no output
    fold_err = _rel_err(out[0], plain_out[0])
    if not fold_err <= I_FOLD_TOL:
        raise AssertionError(f"I/infer {name} (a): transpiled logits vs the "
                             f"untranspiled {fold_err} > {I_FOLD_TOL}")
    del t_exe
    torch.cuda.empty_cache()
    # (b) the saved model, loaded into a Predictor on the card
    pred = create_predictor(Config(saved, place=place))
    (got,) = pred.run({"img": images})
    saved_err = _rel_err(got, out[1])
    if not saved_err <= I_SAVED_TOL:
        raise AssertionError(f"I/infer {name} (b): the saved model's "
                             f"Predictor vs the transpiled forward "
                             f"{saved_err} > {I_SAVED_TOL}")
    # (c) the same directory on the CPU, at batch I_CPU_BATCH
    small = {"img": images[:I_CPU_BATCH]}
    (on_cpu,) = create_predictor(Config(saved, place=CPUPlace())).run(small)
    (on_card,) = pred.run(small)
    cpu_err = _rel_err(on_card, on_cpu)
    if not cpu_err <= I_CPU_TOL:
        raise AssertionError(f"I/infer {name} (c): card vs CPU {cpu_err} > "
                             f"{I_CPU_TOL}")
    busy = prof["busy_ms_per_step"] if prof else None
    plain_busy = plain_prof["busy_ms_per_step"] if plain_prof else None
    res = {"phase": "I/infer", "model": name, "batch": I_BATCH,
           "dtype": "float32", "ops": len(types),
           "batch_norms_left": types.count("batch_norm"),
           "img_per_s": I_BATCH / host_ms * 1e3, "ms_per_batch": host_ms,
           "card_busy_ms": busy,
           "idle_share_profiled": prof["idle_share"] if prof else None,
           "idle_share_unprofiled": 1.0 - busy / host_ms if busy else None,
           "peak_mem_mib": peak[0], "peak_reserved_mib": peak[1],
           "graphs": graphs, "top_kernels_ms":
               prof["top_kernels_ms_per_step"] if prof else None,
           "untranspiled_ms_per_batch": plain_ms,
           "untranspiled_card_busy_ms": plain_busy,
           "untranspiled_top_kernels_ms": plain_prof[
               "top_kernels_ms_per_step"] if plain_prof else None,
           "a_fold_max_rel_err": fold_err, "b_saved_max_rel_err": saved_err,
           "c_cpu_max_rel_err": cpu_err,
           "cpu_reference_img_per_s": INFER_PUBLISHED[name], "card": card}
    log(f"  I/infer {name} batch {I_BATCH} float32: "
        f"{res['img_per_s']:.1f} img/s, {host_ms:.3f} ms/batch, card {busy} "
        f"ms, idle profiled {res['idle_share_profiled']}, unprofiled "
        f"{res['idle_share_unprofiled']}; peak {peak[0]:.0f} MiB allocated, "
        f"{peak[1]:.0f} reserved; graphs {graphs}; {len(types)} ops, "
        f"{types.count('batch_norm')} batch norms left  [{card}]")
    log(f"    top kernels (ms): {res['top_kernels_ms']}")
    log(f"    untranspiled: {plain_ms:.3f} ms/batch, card {plain_busy} ms; "
        f"top kernels {res['untranspiled_top_kernels_ms']}")
    log(f"    (a) transpiled vs untranspiled logits {fold_err:.2e} of the "
        f"largest; (b) saved-model Predictor vs (a) {saved_err:.2e}; (c) "
        f"card vs CPU Predictor at batch {I_CPU_BATCH} {cpu_err:.2e}")
    if name == "resnet50":
        res["d"] = check_clones(pred, card)
    del pred, scope
    shutil.rmtree(saved, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


def phase_gen(card):
    """I/gen: transformer-base's training program (seq 256, src_lens),
    seeded startup, saved as an inference model of its logits; a Predictor
    on the card loads it and generates NEW_TOKENS greedy tokens at phase
    B's shape (batch 8, 256-token sources, prefixes of 512-1024, a
    2048-slot cache).  The tokens equal a decode.Generator's over the
    saving scope; #1 and #6 launch as the gate predicts; a later generate
    on the same spec reuses the cached Generator and captures nothing."""
    from paddle_tpu_torch import (CUDAPlace, Executor, Program, Scope,
                                  decode, io, program_guard, scope_guard,
                                  unique_name)
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops.cuda import flash_decode, mha_block

    place = CUDAPlace(0)
    cfg = transformer.base()
    main, startup = Program(), Program()
    startup.random_seed = SEED
    with program_guard(main, startup), unique_name.guard():
        _, logits = transformer.build(cfg, seq_len=SEQ, use_src_lens=True)
    scope, exe = Scope(), Executor(place)
    exe.run(startup, scope=scope)
    saved = _saved_dir("transformer_base")
    t0 = time.perf_counter()
    with scope_guard(scope):
        io.save_inference_model(saved, ["src_ids", "trg_ids", "src_lens"],
                                [logits], exe, main_program=main)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = create_predictor(Config(saved, place=place))
    load_s = time.perf_counter() - t0
    prefix_len, prefix_range, max_len = PHASES["B"]
    spec = decode_spec(cfg, prefix_len, max_len)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    feed, _ = make_feed(np.random.RandomState(SEED + ord("I")), prefix_len,
                        prefix_range, cfg.trg_vocab_size)
    pred.generate(spec, feed, 2)      # uncounted warm-up
    gen = pred._generators[id(spec)][1]

    cuda_sync()
    reset_peak_memory()
    _zero_counts()
    g0 = graph_stats()
    t0 = time.perf_counter()
    tokens = pred.generate(spec, feed, NEW_TOKENS)
    cuda_sync()
    wall = time.perf_counter() - t0
    counts = {"mha_block": mha_block.launches,
              "flash_decode": flash_decode.launches}
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    steps = tokens.shape[1] - 1
    expect = {"mha_block": 3 * n_layer + n_layer * steps,
              "flash_decode": n_layer * steps}
    if counts != expect or not (counts["mha_block"] > 0
                                and counts["flash_decode"] > 0):
        raise AssertionError(f"I/gen: launches {counts}, the gate predicts "
                             f"{expect}")
    ref = decode.Generator(spec, scope=scope, place=place).generate(
        feed, NEW_TOKENS)
    if not np.array_equal(tokens, ref):
        raise AssertionError("I/gen: the Predictor's tokens differ from the "
                             "saving scope's Generator's")
    g1 = graph_stats()
    t0 = time.perf_counter()
    again = pred.generate(spec, feed, NEW_TOKENS)
    cuda_sync()
    wall2 = time.perf_counter() - t0
    graphs2 = graph_stats(g1)
    if not (np.array_equal(again, tokens) and len(pred._generators) == 1
            and pred._generators[id(spec)][1] is gen
            and graphs2["captures"] == 0):
        raise AssertionError(f"I/gen: a later generate on the same spec: "
                             f"tokens equal {np.array_equal(again, tokens)}, "
                             f"generators {len(pred._generators)}, graphs "
                             f"{graphs2}")
    prefill_ms = []
    with torch.inference_mode():
        for _ in range(3):
            cuda_sync()
            t0 = time.perf_counter()
            gen._prefill(feed)
            cuda_sync()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
    prefill = statistics.median(prefill_ms)
    res = {"phase": "I/gen", "batch": BATCH, "src_len": SRC_LEN,
           "prefix_len": prefix_len, "max_len": max_len,
           "tokens": list(tokens.shape), "save_s": save_s, "load_s": load_s,
           "launches": counts, "graphs_counted_run": graphs,
           "graphs_later_run": graphs2,
           "tokens_per_s": tokens.size / wall2,
           "tokens_per_s_counted_run": tokens.size / wall,
           "prefill_ms": prefill,
           "host_ms_per_step": (wall2 * 1e3 - prefill) / steps,
           "peak_mem_mib": peak, "card": card}
    log(f"  I/gen transformer-base saved ({save_s:.1f} s) and loaded into a "
        f"Predictor ({load_s:.1f} s): {tokens.shape[0]}x{tokens.shape[1]} "
        f"tokens = the saving scope's Generator; launches {counts}; counted "
        f"run {res['tokens_per_s_counted_run']:.1f} tokens/s, graphs "
        f"{graphs}; later run {res['tokens_per_s']:.1f} tokens/s, prefill "
        f"{prefill:.2f} ms, {res['host_ms_per_step']:.3f} host ms/step, "
        f"graphs {graphs2}; peak {peak:.0f} MiB  [{card}]")
    del pred, scope, gen
    shutil.rmtree(saved, ignore_errors=True)
    torch.cuda.empty_cache()
    return res, counts


def drive_saved_models(card, lap=lambda phase: None):
    """Phase 11: bench.py's infer leg (I/infer) and Predictor.generate
    (I/gen); `lap(phase)` after each."""
    results = []
    for name in INFER_PUBLISHED:
        results.append(phase_infer_model(name, card))
        lap(f"[11] I/infer {name}")
    log("    CPU reference, not a yardstick: the reference's published "
        "bs=16 float32 rates on a 2S Xeon 6148 (IntelOptimizedPaddle.md, "
        f"bench.py:600-605), img/s: {json.dumps(INFER_PUBLISHED)}")
    rn = results[0]
    log(f"    ResNet-50 forward, batch {I_BATCH}: card "
        f"{rn['untranspiled_card_busy_ms']} ms without the transpiler, "
        f"{rn['card_busy_ms']} ms with it (host "
        f"{rn['untranspiled_ms_per_batch']:.3f} vs "
        f"{rn['ms_per_batch']:.3f} ms)  [{card}]")
    res, counts = phase_gen(card)
    results.append(res)
    lap("[11] I/gen")
    return results, counts


# ------------------------------------------- [12] the serving front end

# F/rpc: phase S's shapes over loopback TCP (serve + ServingClient)
FE_REQUESTS, FE_CLIENTS = 16, 8
FE_TIMEOUT_S = 300.0          # a client's read deadline (never reached)
# F/tax and F/sweep: bench.py's serving leg (bench.py:966-1275) at
# transformer-base width: 8 streams, 32-token sources, 8-token prompts, 24
# new tokens, a 96-slot cache, the host pool
TAX_STREAMS, TAX_SRC, TAX_PREFIX, TAX_TOKENS, TAX_MAX_LEN = 8, 32, 8, 24, 96
TAX_PAIRS = 10                # interleaved dark/instrumented round pairs
SWEEP_MULTS, SWEEP_REQUESTS = (0.5, 1.0, 2.0, 4.0), 40
# F/overload: bench.py's overload A/B (bench.py:1729-1930) at this width
OV_SRC, OV_PREFIX, OV_TOKENS, OV_MAX_LEN = 16, 4, 12, 48
OV_BATCH, OV_BLOCK, OV_BLOCKS, OV_PROMPTS = 6, 8, 96, 64
OV_MULTS, OV_BURST_S, OV_BURST_MAX = (1.0, 2.0, 4.0, 8.0), 5.0, 1800


def _threads_since(before):
    from paddle_tpu_torch.framework import cuda_graph

    now = dict(cuda_graph.THREADS)
    return {f"{kind}@{name}": n - before.get((kind, name), 0)
            for (kind, name), n in now.items()
            if n - before.get((kind, name), 0)}


def _pcts(values):
    v = np.asarray(values, np.float64)
    return {"p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99)), "n": int(v.size)}


def _one_trace_each(n, timeout=30.0):
    """Every request's spans form one trace: the client's channel attempt,
    the handler's "serving.submit" under it and the Scheduler's
    "serving.request" under that.  The server's spans end just after it
    sent DONE: wait for all of them.  Returns the traces that hold."""
    from paddle_tpu_torch import telemetry

    deadline = time.monotonic() + timeout
    while True:
        spans = telemetry.spans()
        done = sum(r["name"] in ("serving.submit", "serving.request")
                   for r in spans)
        if done >= 2 * n or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    by_trace = {}
    for r in spans:
        by_trace.setdefault(r["trace"], []).append(r)
    good = 0
    for recs in by_trace.values():
        names = {r["name"]: r for r in recs}
        a = names.get("rpc.serving.attempt")
        s = names.get("serving.submit")
        q = names.get("serving.request")
        if (len(recs) == 3 and a and s and q and s["parent"] == a["span"]
                and q["parent"] == s["span"] and q["status"] == "ok"):
            good += 1
    if good != n or len(by_trace) != n:
        raise AssertionError(f"phase F/rpc: {good} of {len(by_trace)} "
                             f"traces stitched, {n} requests")
    return good


def phase_f_rpc(card, s_step_ms):
    """transformer-base served over loopback TCP: serve(..., paged_kv=True)
    at phase S's shapes (256-token sources, 2048-token windows, prompts
    of 1024-2048 tokens, a 4096-slot cache, blocks of 16, 8 slots),
    telemetry on, admission off.

    Warm-up: every bucket (1, 2, 4, 8) twice, each group submitted at
    once (under the step lock, so that it is admitted whole) and served
    to the end by the loop thread: its eager warm-up, then its capture.
    Counted: 16 requests of 32 tokens from 8 client threads, each with its
    own ServingClient, streaming through on_token; launches predicted
    from the scheduler's counters as in phase S.  Then the wire's other
    ops: PING, STATS, STATUS, an expired SUBMIT, DRAIN, a client gone
    after 2 tokens, QUIESCE."""
    from paddle_tpu_torch import CUDAPlace, Scope, decode, serving, telemetry
    from paddle_tpu_torch.framework import cuda_graph
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.resilience import RpcPolicy
    from paddle_tpu_torch.serving import rpc

    place = CUDAPlace(0)
    spec = decode_spec(transformer.base(), S_WINDOW, S_MAX_LEN)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    scope = Scope()
    gen = decode.Generator(spec, scope=scope, place=place)  # seeded startup
    feeds = _request_feeds(np.random.RandomState(_phase_seed("F/rpc")),
                           FE_REQUESTS + 1, vocab)
    telemetry.enable()
    telemetry.reset_metrics()
    telemetry.reset_spans()
    policy = RpcPolicy(call_timeout=FE_TIMEOUT_S, max_attempts=1)
    srv, sched = serving.serve(spec, scope, place=place, max_batch=S_SLOTS,
                               block_size=S_BLOCK, paged_kv=True)
    # from here on, every program the server runs is the loop thread's
    threads0 = dict(cuda_graph.THREADS)
    cli = serving.ServingClient(srv.endpoint, policy)
    try:
        warm_n = 2 * sum(sched._buckets)
        warm = _request_feeds(
            np.random.RandomState(_phase_seed("F/rpc/warm")), warm_n, vocab)
        g0 = graph_stats()
        t0 = time.perf_counter()
        it = iter(warm)
        for b in list(sched._buckets) * 2:
            with sched._step_lock:
                hs = [sched.submit(next(it), 3, eos_id=-1) for _ in range(b)]
            for h in hs:
                h.result(timeout=FE_TIMEOUT_S)
        warmed = graph_stats(g0)
        warmed["wall_s"] = round(time.perf_counter() - t0, 3)
        st = cli.status()
        warm_submitted = st["metrics"]["counters"]["serving.submitted"]
        if warm_submitted != warm_n:
            raise AssertionError(f"phase F/rpc: STATUS counts "
                                 f"{warm_submitted} warm-up submits of "
                                 f"{warm_n}")
        _reset_served(sched)
        telemetry.reset_metrics()
        telemetry.reset_spans()

        def window(label, fs, via):
            """FE_REQUESTS requests of NEW_TOKENS tokens from FE_CLIENTS
            threads, each taking every FE_CLIENTS-th feed: through the
            wire (its own ServingClient, streaming through on_token) or
            in process (submit, then iterate the handle's stream()).
            Launches held against the prediction from the scheduler's
            counters, as in phase S."""
            out = [None] * FE_REQUESTS

            def client(k):
                c = (serving.ServingClient(srv.endpoint, policy)
                     if via == "rpc" else None)
                try:
                    for i in range(k, FE_REQUESTS, FE_CLIENTS):
                        first, t = [], time.perf_counter()
                        if c is not None:
                            toks, status = c.generate(
                                fs[i], NEW_TOKENS, eos_id=-1,
                                on_token=lambda _t: first or first.append(
                                    time.perf_counter()))
                            toks = toks.tolist()
                        else:
                            h = sched.submit(fs[i], NEW_TOKENS, eos_id=-1)
                            for _ in h.stream():
                                first or first.append(time.perf_counter())
                            toks, status = list(h.tokens), h.status
                        out[i] = (toks, status,
                                  (first[0] - t) * 1e3 if first else None)
                finally:
                    if c is not None:
                        c.close()

            cuda_sync()
            reset_peak_memory()
            _zero_counts()
            c0 = dict(sched.counters)
            g0 = graph_stats()
            rec = sched.step = Recorder(sched)   # the loop thread calls it
            workers = [threading.Thread(target=client, args=(k,))
                       for k in range(FE_CLIENTS)]
            t0 = time.perf_counter()
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=FE_TIMEOUT_S)
            cuda_sync()
            wall = time.perf_counter() - t0
            del sched.step
            counts = launch_counts()
            graphs = graph_stats(g0)
            peak = torch.cuda.max_memory_allocated()
            if any(r is None for r in out):
                raise AssertionError(f"phase F/rpc ({label}): a client "
                                     "thread did not finish")
            steps = sched.counters["steps"] - c0["steps"]
            batches = sched.counters["prefill_batches"] \
                - c0["prefill_batches"]
            expect = {"mha_block": n_layer * (steps + 2 * batches),
                      "flash_decode": 0,
                      "flash_decode_paged": n_layer * steps,
                      "flash_attention_fwd": n_layer * batches}
            if counts != expect:
                raise AssertionError(f"phase F/rpc ({label}): launches "
                                     f"{counts}, the gate predicts {expect} "
                                     f"for {steps} steps and {batches} "
                                     "prefill batches")
            decode_ms = [r["ms"] for r in rec.pure("steps")]
            return out, {
                "window": label, "via": via, "telemetry": telemetry.enabled(),
                "launches": counts, "steps": steps,
                "prefill_batches": batches, "wall_s": wall,
                "tokens_per_s": FE_REQUESTS * NEW_TOKENS / wall,
                "ttft_client_ms": _pcts([r[2] for r in out]),
                "host_ms_per_decode_step": statistics.median(decode_ms),
                "decode_steps_timed": len(decode_ms), "graphs": graphs,
                "peak_mem_mib": peak / 2 ** 20}

        # the main path, counted: telemetry on, through the wire
        results, lit = window("instrumented", feeds, "rpc")
        counts, steps = lit["launches"], lit["steps"]
        batches, wall, graphs = lit["prefill_batches"], lit["wall_s"], \
            lit["graphs"]
        traces = _one_trace_each(FE_REQUESTS)
        st = cli.status()
        snap = st["metrics"]
        submitted = snap["counters"]["serving.submitted"]
        if submitted != FE_REQUESTS:
            raise AssertionError(f"phase F/rpc: STATUS counts {submitted} "
                                 f"submits, {FE_REQUESTS} sent")
        ttft_reg = snap["histograms"]["serving.ttft_ms"]
        if ttft_reg["count"] != FE_REQUESTS:
            raise AssertionError(f"phase F/rpc: serving.ttft_ms {ttft_reg}")
        # the same traffic on other prompts with telemetry off, through
        # the wire and then in process: what the instruments cost on the
        # step's host time, and what the handler threads' frames cost
        telemetry.disable()
        controls = []
        for label, via in (("dark", "rpc"), ("dark in-process", "local")):
            fs = _request_feeds(np.random.RandomState(_phase_seed(
                f"F/rpc/{label}")), FE_REQUESTS, vocab)
            out, win = window(label, fs, via)
            counts = _add(counts, win["launches"])
            controls.append((win, out, fs))
        telemetry.enable()

        # the wire's other ops
        pong = cli.ping()
        stats = cli.stats()
        if not pong["ok"] or stats["completed"] != 3 * FE_REQUESTS:
            raise AssertionError(f"phase F/rpc: PING {pong}, STATS "
                                 f"completed {stats['completed']}")
        host, port = srv.endpoint.rsplit(":", 1)
        with socket.create_connection((host, int(port)), 10.0) as s:
            s.settimeout(30.0)
            rpc._send_frame(s, rpc.OP_SUBMIT, rpc._pack_submit(
                feeds[0], {"max_new_tokens": 4, "deadline_ms": 0}))
            op, payload = rpc._recv_frame(s)
        reason = json.loads(payload.decode("utf-8")).get("reason") \
            if op == rpc.OP_REJECT else None
        if reason != "expired" or sched.counters["submitted"] != \
                3 * FE_REQUESTS:
            raise AssertionError(f"phase F/rpc: an expired SUBMIT got op "
                                 f"{op} ({reason}); submitted "
                                 f"{sched.counters['submitted']}")
        cli.drain(True)
        try:
            cli.generate(feeds[1], 2, eos_id=-1)
            raise AssertionError("phase F/rpc: a draining server served")
        except serving.ReplicaDraining:
            pass
        cli.drain(False)
        toks, status = cli.generate(feeds[1], 2, eos_id=-1)
        if status != "done" or toks.tolist() != results[1][0][:2]:
            raise AssertionError(f"phase F/rpc: after undrain {status} "
                                 f"{toks.tolist()}")
        with socket.create_connection((host, int(port)), 10.0) as s:
            s.settimeout(30.0)
            rpc._send_frame(s, rpc.OP_SUBMIT, rpc._pack_submit(
                feeds[FE_REQUESTS], {"max_new_tokens": 500, "eos_id": -1}))
            for _ in range(2):
                op, _ = rpc._recv_frame(s)
                if op != rpc.OP_TOKEN:
                    raise AssertionError(f"phase F/rpc: op {op} streaming")
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not (
                sched.counters["cancelled"] >= 1 and not sched._active):
            time.sleep(0.02)
        if sched.counters["cancelled"] < 1 or sched._active:
            raise AssertionError("phase F/rpc: a closed client's request "
                                 "was not cancelled")
        quiesced = cli.quiesce(timeout_s=60.0)
        if quiesced["used_blocks"] != 0:
            raise AssertionError(f"phase F/rpc: QUIESCE {quiesced}")
    finally:
        cli.close()
        srv.shutdown()
        srv.server_close()
        sched.close()
        telemetry.disable()
    ran_on = _threads_since(threads0)
    if any(not k.endswith("@serving-sched") for k in ran_on):
        raise AssertionError(f"phase F/rpc: warm-ups or captures off the "
                             f"loop thread: {ran_on}")

    def served(out):
        return [types.SimpleNamespace(status=s, tokens=t, error=None)
                for t, s, _ in out]

    equal = check_served("F/rpc", served(results), feeds[:FE_REQUESTS],
                         gen, NEW_TOKENS)
    for win, out, fs in controls:
        win["requests_equal_to_sequential"] = check_served(
            f"F/rpc ({win['window']})", served(out), fs, gen, NEW_TOKENS)
    controls = [win for win, _, _ in controls]
    res = {"phase": "F/rpc", "requests": FE_REQUESTS,
           "clients": FE_CLIENTS, "new_tokens": NEW_TOKENS,
           "window": S_WINDOW, "prompt_lens": list(S_PROMPTS),
           "max_len": S_MAX_LEN, "block_size": S_BLOCK,
           "max_batch": S_SLOTS, "launches": counts, "steps": steps,
           "prefill_batches": batches, "wall_s": wall,
           "tokens_per_s": lit["tokens_per_s"],
           "ttft_client_ms": lit["ttft_client_ms"],
           "ttft_registry_ms": ttft_reg,
           "host_ms_per_decode_step": lit["host_ms_per_decode_step"],
           "decode_steps_timed": lit["decode_steps_timed"],
           "phase_s_host_ms_per_decode_step": s_step_ms,
           "controls": controls,
           "graphs": graphs, "warm_up": warmed,
           "warm_up_submitted": warm_submitted,
           "ran_on": ran_on, "traces": traces,
           "peak_mem_mib": lit["peak_mem_mib"], "quiesce": quiesced,
           "requests_equal_to_sequential": equal, "card": card}
    log(f"  F/rpc: {FE_REQUESTS}x{NEW_TOKENS} tokens from {FE_CLIENTS} "
        f"client threads in {wall:.3f} s ({res['tokens_per_s']:.1f} "
        f"tokens/s), TTFT client p50/p99 "
        f"{res['ttft_client_ms']['p50']:.2f}/"
        f"{res['ttft_client_ms']['p99']:.2f} ms, serving.ttft_ms p50/p99 "
        f"{ttft_reg['p50']}/{ttft_reg['p99']} ms; host ms per decode step "
        f"{res['host_ms_per_decode_step']:.3f} (median of "
        f"{res['decode_steps_timed']}) beside phase S's {s_step_ms:.3f}  "
        f"[{card}]")
    for win in controls:
        how = "through the wire" if win["via"] == "rpc" else "in process"
        log(f"    control, {win['window']} ({how}, telemetry off): "
            f"{win['tokens_per_s']:.1f} tokens/s, TTFT client p50/p99 {win['ttft_client_ms']['p50']:.2f}/"
            f"{win['ttft_client_ms']['p99']:.2f} ms, host ms per decode "
            f"step {win['host_ms_per_decode_step']:.3f} (median of "
            f"{win['decode_steps_timed']}); {win['steps']} steps, "
            f"launches {win['launches']}; "
            f"{win['requests_equal_to_sequential']}/{FE_REQUESTS} requests "
            f"equal the sequential Generator")
    log(f"    {steps} steps, {batches} prefill batches; launches (all three "
        f"windows) {counts}; "
        f"CUDA graphs in the counted run {graphs} (warm-up: {warmed}); "
        f"warm-ups and captures by thread {ran_on}; {traces} stitched "
        f"traces; STATUS serving.submitted {warm_submitted} (warm-up) + "
        f"{submitted}; peak {res['peak_mem_mib']:.0f} MiB; "
        f"{equal}/{FE_REQUESTS} requests equal the sequential Generator")
    log("    PING, STATS, STATUS answered; expired SUBMIT refused; DRAIN "
        "refused a submit, undrain served it; a client gone after 2 "
        f"tokens cancelled its request; QUIESCE {quiesced}")
    return res, counts


def _bench_feed(vocab, src_len, prefix, seed):
    """bench.py's serving and overload feeds (bench.py:1004-1011,
    :1769-1776): full-length sources and prompts from RandomState(seed)."""
    r = np.random.RandomState(seed)
    return {
        "src_ids": r.randint(2, vocab, (1, src_len)).astype(np.int64),
        "src_lens": np.full(1, src_len, np.int64),
        "trg_ids": r.randint(2, vocab, (1, prefix)).astype(np.int64),
        "prefix_lens": np.full(1, prefix, np.int64),
    }


def _warm_buckets(sched, feed, new_tokens=2, buckets=None):
    """Every bucket's (or `buckets`') prefill and step signatures run twice
    (an eager warm-up, then a capture) on fresh prompts, in the calling
    thread."""
    seed = 0
    for _ in range(2):
        for b in sched._buckets if buckets is None else buckets:
            hs = [sched.submit(feed(9000 + seed + i), new_tokens, eos_id=-1)
                  for i in range(b)]
            seed += b
            sched.run_until_idle(max_steps=100000)
            if not all(h.status == "done" for h in hs):
                raise AssertionError("warm-up request not done")


def _check_prefixes(phase, handles):
    """Each (handle, reference) pair: the handle's tokens are a prefix of
    the sequential Generator's (all of them for a request done at full
    length).  A divergence goes to DIVERGED.  Returns the pairs equal."""
    bad = 0
    for i, (h, ref) in enumerate(handles):
        toks = list(h.tokens)
        if toks != list(ref[:len(toks)]):
            t = next(j for j, (a, b) in enumerate(zip(toks, ref)) if a != b)
            DIVERGED.append({"phase": phase, "request": i, "step": t,
                             "got": toks[t], "want": int(ref[t])})
            log(f"    DIVERGED {DIVERGED[-1]}")
            bad += 1
    return len(handles) - bad


def _front_expect(steps, n_layer, paged):
    """A bench.py leg's launches for `steps` decode steps: its prefill
    windows take the composite (no kernel); a host-pool step runs #6 twice
    a layer (the dense cache and the source), a device-pool step #7 and #6
    once each."""
    return {"mha_block": 0,
            "flash_decode": n_layer * steps * (1 if paged else 2),
            "flash_decode_paged": n_layer * steps if paged else 0,
            "flash_attention_fwd": 0}


class _Counted:
    """One leg's launch counts: zeroed on entry, read on exit and held
    against _front_expect for the decode steps (replay steps included)
    the leg's schedulers ran in between."""

    def __init__(self, phase, scheds, n_layer):
        self.phase, self.scheds, self.n_layer = phase, list(scheds), n_layer

    def __enter__(self):
        cuda_sync()
        _zero_counts()
        self.steps0 = [s.counters["steps"] for s in self.scheds]
        return self

    def __exit__(self, *exc):
        cuda_sync()
        self.counts = launch_counts()
        self.steps = sum(s.counters["steps"] - n
                         for s, n in zip(self.scheds, self.steps0))
        if exc[0] is not None:
            return False
        expect = _front_expect(self.steps, self.n_layer,
                               self.scheds[0].paged_kv)
        if self.counts != expect or not self.steps:
            raise AssertionError(f"phase {self.phase}: launches "
                                 f"{self.counts}, the gate predicts "
                                 f"{expect} for {self.steps} steps")
        return False


def _host_pool_split(sched, feed, seed0):
    """One continuous round (TAX_STREAMS requests) stepped by hand, with
    host timers around the host pool's per-row gathers and row writes and
    the step program's call: host ms a decode step and its parts."""
    acc = {"gather": 0.0, "write_row": 0.0, "program": 0.0}

    def timed(obj, name, key):
        fn = getattr(obj, name)

        def wrap(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            acc[key] += time.perf_counter() - t
            return out
        setattr(obj, name, wrap)

    timed(sched.pool, "gather", "gather")
    timed(sched.pool, "write_row", "write_row")
    timed(sched._gen, "_step", "program")
    try:
        tick = Recorder(sched)
        for i in range(TAX_STREAMS):
            sched.submit(feed(seed0 + i), TAX_TOKENS, eos_id=-1)
        tick()   # the prefill
        for k in acc:
            acc[k] = 0.0
        steps = 0
        while tick():
            steps += tick.log[-1]["steps"]
    finally:
        for obj, name in ((sched.pool, "gather"),
                          (sched.pool, "write_row"), (sched._gen, "_step")):
            del obj.__dict__[name]
    ms = statistics.median(r["ms"] for r in tick.pure("steps"))
    out = {k: 1e3 * v / steps for k, v in acc.items()}
    out["step"] = ms
    out["rest"] = ms - sum(out[k] for k in acc)
    return out


def _poisson_sweep(sched, feed, seq_qps, slo_ms):
    """bench.py's open-loop sweep on a started Scheduler: SWEEP_REQUESTS
    Poisson arrivals at each of SWEEP_MULTS x the sequential capacity,
    25% of them one shared prompt.  Returns the sweep, QPS at SLO (the
    highest achieved rate whose p99 met the SLO) with its p99, and the
    served (handle, prompt seed) pairs."""
    sweep, qps_at_slo, p99_at_slo, served = {}, 0.0, None, []
    for mult in SWEEP_MULTS:
        rate = mult * seq_qps
        gaps = np.random.RandomState(int(10 * mult)).exponential(
            1.0 / rate, size=SWEEP_REQUESTS)
        sub = []
        t_start = time.perf_counter()
        for i, gap in enumerate(gaps):
            time.sleep(max(0.0, gap))
            seed = 100 + (i % 4 if i % 4 == 0 else i)  # 25% shared
            sub.append((sched.submit(feed(seed), TAX_TOKENS, eos_id=-1),
                        seed))
        for h, _ in sub:
            h.result(timeout=600)
        wall = time.perf_counter() - t_start
        if not all(h.status == "done" and len(h.tokens) == TAX_TOKENS
                   for h, _ in sub):
            raise AssertionError("F/sweep: a request not done")
        served += sub
        lat = [1e3 * h.latency() for h, _ in sub]
        p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
        qps = SWEEP_REQUESTS / wall
        sweep[f"{mult:g}x"] = {"offered_qps": rate, "achieved_qps": qps,
                               "p50_ms": p50, "p99_ms": p99,
                               "met_slo": p99 <= slo_ms}
        if p99 <= slo_ms and qps > qps_at_slo:
            qps_at_slo, p99_at_slo = qps, p99
    return sweep, qps_at_slo, p99_at_slo, served


def phase_f_tax_sweep(card):
    """bench.py's serving leg at transformer-base width: the telemetry tax
    (identical continuous rounds on the host pool, telemetry off and on,
    interleaved) with a split of the host pool's decode step, then the
    Poisson open-loop sweep (telemetry on; the queue depth and the prefix
    hit rate read from the registry) on bench.py's host-pool Scheduler
    and on a device-pool one (paged_kv=True)."""
    from paddle_tpu_torch import CUDAPlace, Scope, decode, serving, telemetry
    from paddle_tpu_torch.models import transformer

    place = CUDAPlace(0)
    spec = decode_spec(transformer.base(), TAX_PREFIX, TAX_MAX_LEN,
                       src_len=TAX_SRC)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    scope = Scope()
    gen = decode.Generator(spec, scope=scope, place=place)
    cache, refs = {}, {}

    def feed(seed):
        if seed not in cache:
            cache[seed] = _bench_feed(vocab, TAX_SRC, TAX_PREFIX, seed)
        return cache[seed]

    def ref(seed):
        if seed not in refs:
            refs[seed] = gen.generate(feed(seed), TAX_TOKENS,
                                      eos_id=-1)[0].tolist()
        return refs[seed]

    # the sequential tier: per-request generate(), warmed (eager, capture)
    streams = [100 + i for i in range(TAX_STREAMS)]
    for _ in range(2):
        gen.generate(feed(streams[0]), 2, eos_id=-1)
    cuda_sync()
    t0 = time.perf_counter()
    for seed in streams:
        ref(seed)
    t_seq = time.perf_counter() - t0
    seq_lat_ms = 1e3 * t_seq / TAX_STREAMS
    seq_qps = TAX_STREAMS / t_seq
    slo_ms = TAX_STREAMS * seq_lat_ms

    sched = serving.Scheduler(spec, scope, place=place,
                              max_batch=TAX_STREAMS)
    _warm_buckets(sched, feed)

    def cb_round(seed0):
        t0 = time.perf_counter()
        rs = [sched.submit(feed(seed0 + i), TAX_TOKENS, eos_id=-1)
              for i in range(TAX_STREAMS)]
        sched.run_until_idle(max_steps=100000)
        cuda_sync()
        if not all(r.status == "done" and len(r.tokens) == TAX_TOKENS
                   for r in rs):
            raise AssertionError("F/tax: a request not done")
        return time.perf_counter() - t0, rs

    cb_round(20_000)   # settle caches and the allocator
    dark, lit, rounds = [], [], []
    with _Counted("F/tax", [sched], n_layer) as tax_counted:
        for k in range(TAX_PAIRS):
            for on, times, seed0 in ((False, dark, 21_000),
                                     (True, lit, 22_000)):
                sched.pool.assert_quiesced()
                (telemetry.enable if on else telemetry.disable)()
                dt, rs = cb_round(seed0 + 100 * k)
                times.append(dt)
                rounds.append((rs, seed0 + 100 * k))
        telemetry.disable()
    checked = [(r, ref(seed0 + i)) for rs, seed0 in rounds
               for i, r in enumerate(rs)]
    t_dark, t_lit = statistics.median(dark), statistics.median(lit)
    overhead = 100.0 * (t_lit - t_dark) / t_dark
    q_dark, q_lit = (np.percentile(t, [25, 75]).tolist()
                     for t in (dark, lit))
    # each pair's own overhead: drift between pairs cancels inside one
    per_pair = [100.0 * (b - a) / a for a, b in zip(dark, lit)]
    q_pair = np.percentile(per_pair, [25, 50, 75]).tolist()
    sched.pool.assert_quiesced()
    split = _host_pool_split(sched, feed, 23_000)
    equal_tax = _check_prefixes("F/tax", checked)
    tax = {"phase": "F/tax", "streams": TAX_STREAMS, "src_len": TAX_SRC,
           "prefix": TAX_PREFIX, "new_tokens": TAX_TOKENS,
           "max_len": TAX_MAX_LEN, "pairs": TAX_PAIRS, "dark_s": dark,
           "instrumented_s": lit, "dark_median_s": t_dark,
           "instrumented_median_s": t_lit, "overhead_pct": overhead,
           "dark_quartiles_s": q_dark, "instrumented_quartiles_s": q_lit,
           "pair_overhead_pct_quartiles": q_pair,
           "launches": tax_counted.counts, "steps": tax_counted.steps,
           "host_pool_step_ms": split,
           "requests_equal_to_sequential": equal_tax, "card": card}
    log(f"  F/tax: {TAX_PAIRS} interleaved pairs of {TAX_STREAMS}x"
        f"{TAX_TOKENS}-token continuous rounds on the host pool: dark "
        f"median {t_dark:.4f} s (quartiles {q_dark[0]:.4f}-{q_dark[1]:.4f},"
        f" range {min(dark):.4f}-{max(dark):.4f}), instrumented "
        f"{t_lit:.4f} s (quartiles {q_lit[0]:.4f}-{q_lit[1]:.4f}, range "
        f"{min(lit):.4f}-{max(lit):.4f}), overhead of the medians "
        f"{overhead:.2f}%, per pair p25/p50/p75 {q_pair[0]:.2f}/"
        f"{q_pair[1]:.2f}/{q_pair[2]:.2f}% ({equal_tax}/{len(checked)} "
        f"requests equal the sequential Generator)  [{card}]")
    log(f"    {tax_counted.steps} decode steps, launches "
        f"{tax_counted.counts}")
    log(f"    a host-pool decode step of {TAX_STREAMS} rows: "
        f"{split['step']:.3f} host ms (median): gathers "
        f"{split['gather']:.3f}, the program's call {split['program']:.3f}, "
        f"row writes {split['write_row']:.3f}, the rest (argmax read-back, "
        f"Python) {split['rest']:.3f}; the sequential Generator "
        f"{seq_lat_ms / TAX_TOKENS:.3f} ms a token")

    results, counts = [tax], dict(tax_counted.counts)
    paged = serving.Scheduler(spec, scope, place=place,
                              max_batch=TAX_STREAMS, block_size=S_BLOCK,
                              paged_kv=True)
    _warm_buckets(paged, feed)
    for label, sc in (("F/sweep", sched), ("F/sweep/paged", paged)):
        telemetry.reset_metrics()
        telemetry.reset_spans()
        telemetry.enable()
        with _Counted(label, [sc], n_layer) as counted:
            sc.start()
            try:
                sweep, qps_at_slo, p99_at_slo, served = _poisson_sweep(
                    sc, feed, seq_qps, slo_ms)
                snap = telemetry.snapshot()
            finally:
                sc.close()
                telemetry.disable()
        counts = _add(counts, counted.counts)
        served = [(h, ref(seed)) for h, seed in served]
        equal = _check_prefixes(label, served)
        hits = snap["counters"]["kv.prefix_hits"]
        misses = snap["counters"]["kv.prefix_misses"]
        qd = snap["histograms"]["serving.queue_depth_per_step"]
        fill = snap["histograms"]["serving.bucket_fill"]
        res = {"phase": label, "paged_kv": sc.paged_kv, "slo_ms": slo_ms,
               "sequential_latency_ms": seq_lat_ms,
               "sequential_capacity_qps": seq_qps,
               "requests_per_rate": SWEEP_REQUESTS, "sweep": sweep,
               "qps_at_slo": qps_at_slo, "p99_at_slo_ms": p99_at_slo,
               "queue_depth_per_step": qd, "bucket_fill": fill,
               "prefix_hit_rate": hits / max(1, hits + misses),
               "launches": counted.counts, "steps": counted.steps,
               "requests_equal_to_sequential": equal, "card": card}
        results.append(res)
        log(f"  {label} (paged_kv={sc.paged_kv}): sequential tier "
            f"{seq_lat_ms:.2f} ms a request ({seq_qps:.2f} req/s), SLO "
            f"{slo_ms:.1f} ms; QPS at SLO {qps_at_slo:.2f} (p99 "
            f"{p99_at_slo} ms); registry: queue depth per step p50/p99 "
            f"{qd['p50']}/{qd['p99']}, bucket fill mean {fill['mean']}, "
            f"prefix hit rate {res['prefix_hit_rate']:.4f}; "
            f"{equal}/{len(served)} requests equal the sequential "
            f"Generator; {counted.steps} decode steps, launches "
            f"{counted.counts}  [{card}]")
        for k, v in sweep.items():
            log(f"    {k}: offered {v['offered_qps']:.2f} req/s, achieved "
                f"{v['achieved_qps']:.2f}, p50 {v['p50_ms']:.1f} ms, p99 "
                f"{v['p99_ms']:.1f} ms, met SLO {v['met_slo']}")
    return results, counts


def _live_capture_skew(spec, scope, place, prompts):
    """What a CUDA-graph capture during live traffic does to the admission
    estimators: a Scheduler with admission on, every bucket but the
    largest warmed, its EWMAs reset and settled on a smaller bucket's
    rounds; then one round at the largest bucket, whose first calls are an
    eager warm-up and a capture.  After every iteration a probe prices a
    calm request (OV_TOKENS tokens, no backlog) against a 250 ms deadline,
    the F/overload SLO's floor, through the gate's own arithmetic."""
    from paddle_tpu_torch import serving

    sched = serving.Scheduler(spec, scope, place=place, max_batch=OV_BATCH,
                              block_size=OV_BLOCK, num_blocks=OV_BLOCKS,
                              admission=True)
    oc = sched._overload
    _warm_buckets(sched, lambda s: prompts[s % OV_PROMPTS],
                  buckets=sched._buckets[:-1])
    oc._step_ms = oc._prefill_ms = None
    small = sched._buckets[-2]
    for k in range(4):
        for i in range(small):
            sched.submit(prompts[(small * k + i) % OV_PROMPTS], OV_TOKENS,
                         eos_id=-1)
        sched.run_until_idle(max_steps=100000)
    before, pre_before = oc.step_ms(), oc._prefill_ms
    est_before = oc.estimate_ms(OV_TOKENS, 0)
    for i in range(OV_BATCH):   # prompts neither round has seen: a prefill
        sched.submit(prompts[20 + i], OV_TOKENS, eos_id=-1)
    trail, ests, rejects = [], [], 0
    while sched.step():
        trail.append(oc.step_ms())
        est = oc.estimate_ms(OV_TOKENS, 0)
        ests.append(est)
        rejects += est > 250.0
    settled = trail[-1]
    res = {"before_ms": before, "peak_ms": max(trail), "settled_ms": settled,
           "steps_over_2x": sum(1 for v in trail if v > 2 * settled),
           "prefill_before": pre_before, "prefill_after": oc._prefill_ms,
           "est_before": est_before, "est_peak": max(ests),
           "probes": len(ests), "rejects": rejects, "trail_ms": trail}
    sched.pool.assert_quiesced()
    sched.close()
    return res


def phase_f_overload(card):
    """bench.py's overload A/B at transformer-base width: the same open-loop
    Poisson burst at 1x, 2x, 4x and 8x of the measured capacity, with the
    admission gate and brownout ON and OFF; half the arrivals interactive
    (deadline = the SLO), half batch.  Goodput counts the interactive
    requests done inside the SLO over the leg's wall clock."""
    from paddle_tpu_torch import CUDAPlace, Scope, decode, serving
    from paddle_tpu_torch.models import transformer

    place = CUDAPlace(0)
    spec = decode_spec(transformer.base(), OV_PREFIX, OV_MAX_LEN,
                       src_len=OV_SRC)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    scope = Scope()
    gen = decode.Generator(spec, scope=scope, place=place)
    prompts = [_bench_feed(vocab, OV_SRC, OV_PREFIX, 31_000 + p)
               for p in range(OV_PROMPTS)]
    refs = [gen.generate(f, OV_TOKENS, eos_id=-1)[0].tolist()
            for f in prompts]

    def mk_sched(admission):
        sched = serving.Scheduler(spec, scope, place=place,
                                  max_batch=OV_BATCH, block_size=OV_BLOCK,
                                  num_blocks=OV_BLOCKS, admission=admission)
        _warm_buckets(sched, lambda s: prompts[s % OV_PROMPTS])
        poisoned = None
        if sched._overload is not None:
            # warm-up and capture times fed the estimators: start over
            poisoned = sched._overload.view()
            sched._overload._step_ms = None
            sched._overload._prefill_ms = None
        return sched, poisoned

    live = _live_capture_skew(spec, scope, place, prompts)
    sched_on, poisoned = mk_sched(True)
    for k in range(6):   # settle rounds rebuild the estimators
        hs = [sched_on.submit(prompts[(24 * k + i) % OV_PROMPTS], OV_TOKENS,
                              eos_id=-1) for i in range(24)]
        sched_on.run_until_idle(max_steps=100000)
        if not all(h.status == "done" for h in hs):
            raise AssertionError("F/overload: a settle request not done")
    t0 = time.perf_counter()
    hs = [sched_on.submit(prompts[i % OV_PROMPTS], OV_TOKENS, eos_id=-1)
          for i in range(48)]
    sched_on.run_until_idle(max_steps=100000)
    capacity = 48 / (time.perf_counter() - t0)
    settled = sched_on._overload.view()
    est_calm = sched_on._overload.estimate_ms(OV_TOKENS, 0) or 100.0
    slo_ms = float(min(10_000.0, max(250.0, 3.0 * est_calm)))

    def burst(sched, mult, seed):
        rate = mult * capacity
        n_req = min(OV_BURST_MAX, max(48, int(OV_BURST_S * rate)))
        r = np.random.RandomState(seed)
        arrivals = np.cumsum(r.exponential(1.0 / rate, size=n_req))
        kinds = r.rand(n_req) < 0.5
        which = r.randint(0, OV_PROMPTS, size=n_req)
        accepted, rejected = [], 0
        t_start = time.perf_counter()
        for at, interactive, p in zip(arrivals, kinds, which):
            time.sleep(max(0.0, float(at) - (time.perf_counter() - t_start)))
            try:
                if interactive:
                    h = sched.submit(prompts[p], OV_TOKENS, deadline_ms=slo_ms,
                                     eos_id=-1, priority="interactive")
                else:
                    h = sched.submit(prompts[p], OV_TOKENS, eos_id=-1,
                                     priority="batch")
                accepted.append((bool(interactive), int(p), h))
            except serving.AdmissionRejected:
                rejected += 1
        for _, _, h in accepted:
            h.result(timeout=600.0)
        wall = time.perf_counter() - t_start
        equal = _check_prefixes(f"F/overload {mult:g}x",
                                [(h, refs[p]) for _, p, h in accepted])
        clamped_interactive = sum(
            1 for i, _, h in accepted
            if i and h.status == "done" and len(h.tokens) != OV_TOKENS)
        if clamped_interactive:
            raise AssertionError(f"F/overload: {clamped_interactive} "
                                 "interactive requests done short")
        lats = [h.latency() * 1e3 for i, _, h in accepted
                if i and h.status == "done"]
        good = sum(1 for lat in lats if lat <= slo_ms)
        return {"offered_qps": rate, "offered_n": n_req,
                "accepted": len(accepted), "rejected": rejected,
                "interactive_expired": sum(
                    1 for i, _, h in accepted if i and h.status == "expired"),
                "batch_clamped": sum(
                    1 for i, _, h in accepted
                    if not i and h.status == "done"
                    and len(h.tokens) < OV_TOKENS),
                "goodput_qps": good / wall, "wall_s": wall,
                "p99_ms": float(np.percentile(lats, 99)) if lats else None,
                "accepted_equal_to_sequential": equal}

    sweep = {"on": {}, "off": {}}
    with _Counted("F/overload ON", [sched_on], n_layer) as on_counted:
        sched_on.start()
        try:
            for mult in OV_MULTS:
                sweep["on"][f"{mult:g}x"] = burst(sched_on, mult,
                                                  int(10 * mult))
            on_counters = dict(sched_on._overload.counters)
            with sched_on._step_lock:
                sched_on.pool.assert_quiesced()
        finally:
            sched_on.close()
    sched_off, _ = mk_sched(False)
    with _Counted("F/overload OFF", [sched_off], n_layer) as off_counted:
        sched_off.start()
        try:
            for mult in OV_MULTS:
                sweep["off"][f"{mult:g}x"] = burst(sched_off, mult,
                                                   int(10 * mult))
            with sched_off._step_lock:
                sched_off.pool.assert_quiesced()
        finally:
            sched_off.close()
    counts = _add(on_counted.counts, off_counted.counts)
    res = {"phase": "F/overload", "max_batch": OV_BATCH,
           "live_capture": live,
           "src_len": OV_SRC, "prefix": OV_PREFIX, "new_tokens": OV_TOKENS,
           "max_len": OV_MAX_LEN, "num_blocks": OV_BLOCKS,
           "prompts": OV_PROMPTS, "capacity_qps": capacity,
           "slo_ms": slo_ms, "estimators_after_warm_up": poisoned,
           "estimators_settled": settled, "sweep": sweep,
           "overload_counters_on": on_counters,
           "launches": {"on": on_counted.counts, "off": off_counted.counts},
           "steps": {"on": on_counted.steps, "off": off_counted.steps},
           "goodput_on_4x": sweep["on"]["4x"]["goodput_qps"], "card": card}
    log(f"  F/overload: capacity {capacity:.2f} req/s, SLO {slo_ms:.1f} ms "
        f"(3 x the calm estimate {est_calm:.2f} ms); goodput at SLO, 4x ON "
        f"{res['goodput_on_4x']:.2f} req/s; ON counters {on_counters}  "
        f"[{card}]")
    log(f"    estimators after the warm-up (its eager runs and captures): "
        f"step {poisoned['step_ms_ewma']} ms, prefill "
        f"{poisoned['prefill_tok_ms_ewma']} ms/token; settled: step "
        f"{settled['step_ms_ewma']} ms, prefill "
        f"{settled['prefill_tok_ms_ewma']} ms/token")
    log(f"    a capture in live traffic (bucket {OV_BATCH} first reached "
        f"after the estimators settled on bucket {OV_BATCH - 2}): step EWMA "
        f"{live['before_ms']:.3f} -> peak {live['peak_ms']:.3f} ms, "
        f"{live['steps_over_2x']} steps above 2x its settled value, prefill "
        f"EWMA {live['prefill_before']:.4f} -> {live['prefill_after']:.4f} "
        f"ms/token; a calm {OV_TOKENS}-token estimate {live['est_before']:.1f}"
        f" -> peak {live['est_peak']:.1f} ms, {live['rejects']} of "
        f"{live['probes']} probe admissions at the SLO refused")
    for leg in ("on", "off"):
        for k, v in sweep[leg].items():
            log(f"    {leg.upper()} {k}: offered {v['offered_n']} at "
                f"{v['offered_qps']:.1f} req/s, accepted {v['accepted']}, "
                f"rejected {v['rejected']}, interactive expired "
                f"{v['interactive_expired']}, batch clamped "
                f"{v['batch_clamped']}, goodput {v['goodput_qps']:.2f} "
                f"req/s, interactive p99 {v['p99_ms']} ms, wall "
                f"{v['wall_s']:.2f} s, {v['accepted_equal_to_sequential']}/"
                f"{v['accepted']} equal to the sequential Generator")
    log(f"    decode steps ON {on_counted.steps}, OFF {off_counted.steps}; "
        f"launches ON {on_counted.counts}, OFF {off_counted.counts}")
    return res, counts


def drive_front_end(card, s_step_ms, lap=lambda phase: None):
    """Phase 12: F/rpc, F/tax and F/sweep, F/overload; `lap(phase)` after
    each.  Returns the results and the launches of every counted leg."""
    res, counts = phase_f_rpc(card, s_step_ms)
    results = [res]
    torch.cuda.empty_cache()
    lap("[12] F/rpc")
    more, more_counts = phase_f_tax_sweep(card)
    results += more
    counts = _add(counts, more_counts)
    torch.cuda.empty_cache()
    lap("[12] F/tax, F/sweep")
    res, more_counts = phase_f_overload(card)
    results.append(res)
    counts = _add(counts, more_counts)
    torch.cuda.empty_cache()
    lap("[12] F/overload")
    return results, counts


# ------------------------------------------------- [13] the serving fleet


# F/fleet/inproc and F/fleet: fleet/replica.py's shapes (its DEFAULT_CONFIG,
# bench.py's fleet leg: 8-token sources, 3-token prompts, a 28-slot cache, 4
# slots, 40 blocks of 4, the host pool) with {"model": "base"}.
# F/fleet/inproc: tests/test_fleet.py's traffic, 4 prompt groups x 4 rounds
# of 8 new tokens; F/fleet: bench.py's 8-prompt pool and 10 new tokens,
# FL_PER_CLIENT requests a client (bench.py: max(4, steps // 4))
FL_GROUPS, FL_ROUNDS, FL_INPROC_TOKENS = 4, 4, 8
FL_TOKENS, FL_POOL, FL_PER_CLIENT = 10, 8, 8
FL_SIZES = (1, 2, 4)          # replicas of the weak-scaling sweep
FL_TIMEOUT_S = 120.0          # a fleet client's read deadline (never reached)
FL_SPAWN_S = 300.0            # a replica process's deadline for READY
# F/disagg: bench.py's disagg A/B (bench.py:2231-2490) at transformer-base
# width: 16-token sources, 24-token prompt windows (prompts of 24 or 4), 12
# new tokens, a 48-slot cache, 6 slots, 32 prompts (every 4th long).  Blocks
# of 16 (bench.py: 256 of 8): #7 takes blocks of a multiple of 16
DG_SRC, DG_PREFIX, DG_TOKENS, DG_MAX_LEN = 16, 24, 12, 48
DG_LONG, DG_SHORT, DG_STREAMS, DG_PROMPTS = 24, 4, 6, 32
DG_CHUNK, DG_SWEEP = 8, (4, 8, 16)
DG_BLOCK, DG_BLOCKS, DG_DECODE_BLOCK = 16, 128, 32
DG_WIRE_REQUESTS = 8          # the two-tier fleet over the wire, per half


def _fleet_model():
    """fleet/replica.py's {"model": "base"} replica config, its spec and
    the sequential Generator over a scope whose startup ran on the card
    (the replicas' weights, drawn in each replica's own process)."""
    from paddle_tpu_torch import CUDAPlace, decode
    from paddle_tpu_torch.fleet import replica

    cfg = dict(replica.DEFAULT_CONFIG, model="base")
    spec, scope = replica.build_spec_scope(cfg)
    gen = decode.Generator(spec, scope=scope, place=CUDAPlace(0))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    return cfg, spec, gen, vocab, n_layer


def _test_feed(vocab, seed, src, prefix):
    """tests/test_fleet.py's feeds (ragged source and prompt lengths from
    default_rng(seed)), ids over the model's vocabulary."""
    r = np.random.default_rng(seed)
    return {
        "src_ids": r.integers(2, vocab, size=(1, src)).astype(np.int64),
        "src_lens": np.array([int(r.integers(src // 2, src + 1))], np.int64),
        "trg_ids": r.integers(2, vocab, size=(1, prefix)).astype(np.int64),
        "prefix_lens": np.array([int(r.integers(1, prefix + 1))], np.int64),
    }


def _fleet_client(endpoint, **kw):
    from paddle_tpu_torch.resilience import RpcPolicy
    from paddle_tpu_torch.serving import ServingClient

    kw.setdefault("call_timeout", FL_TIMEOUT_S)
    return ServingClient(endpoint, RpcPolicy(**kw))


def _affine_feed(router, index, feed, lo):
    for seed in range(lo, lo + 512):
        f = feed(seed)
        if router.affine_index(f, 1, None) == index:
            return f
    raise AssertionError(f"no feed in range maps to replica {index}")


def _pool_rate(sched):
    p = sched.stats()["pool"]
    seen = p["prefix_hits"] + p["prefix_misses"]
    return p["prefix_hits"] / max(1, seen), seen


def _wait_for(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out waiting")
        time.sleep(0.02)


def phase_fleet_inproc(card):
    """F/fleet/inproc: three in-process replicas (a Scheduler and a
    ServingServer each, PRIVATE scopes whose startups ran on the card) at
    transformer-base width behind a FleetRouter; tests/test_fleet.py's
    traffic.  The prefix hit rate pooled across them against one replica's
    on the same traffic, a spill away from a stalled replica, and a stream
    the ChaosProxy drops, resubmitted under its request id."""
    from paddle_tpu_torch import CUDAPlace, Scope, fleet, serving
    from paddle_tpu_torch.resilience import ChaosProxy

    cfg, spec, gen, vocab, n_layer = _fleet_model()
    place = CUDAPlace(0)

    def feed(seed):
        return _test_feed(vocab, seed, cfg["src_len"], cfg["prefix_len"])

    def ref(f):
        return gen.generate(f, FL_INPROC_TOKENS, eos_id=1)[0].tolist()

    def replica():
        sched = serving.Scheduler(spec, scope=Scope(), place=place,
                                  max_batch=cfg["max_batch"],
                                  block_size=cfg["block_size"],
                                  num_blocks=cfg["num_blocks"])
        _warm_buckets(sched, feed)
        _reset_served(sched)
        sched.start()
        return serving.ServingServer(sched).start(), sched

    def workload(endpoint):
        cli = _fleet_client(endpoint)
        bad = 0
        try:
            for _ in range(FL_ROUNDS):
                for g, f in enumerate(groups):
                    toks, status = cli.generate(f, FL_INPROC_TOKENS,
                                                eos_id=1)
                    if status != "done":
                        raise AssertionError(f"F/fleet/inproc: {status}")
                    bad += _diverged("F/fleet/inproc", g, toks.tolist(),
                                     refs[g])
        finally:
            cli.close()
        return FL_ROUNDS * len(groups) - bad

    groups = [feed(500 + g) for g in range(FL_GROUPS)]
    refs = [ref(f) for f in groups]
    # the spill's request (affine to replica 0 of two) and the dropped
    # stream, and their references, outside the counted window
    target = _affine_feed(fleet.FleetRouter(["127.0.0.1:1", "127.0.0.1:2"]),
                          0, feed, 3000)
    dropped = feed(41)
    want_target, want_dropped = ref(target), ref(dropped)
    pairs, router, chaos = [], None, None
    try:
        t0 = time.perf_counter()
        pairs = [replica() for _ in range(4)]   # one alone, then three
        warm_s = time.perf_counter() - t0
        single, reps = pairs[0], pairs[1:]
        with _Counted("F/fleet/inproc", [s for _, s in pairs],
                      n_layer) as counted:
            equal = workload(single[0].endpoint)
            single_rate, _ = _pool_rate(single[1])
            router = fleet.FleetRouter([s.endpoint for s, _ in reps]).start()
            t0 = time.perf_counter()
            equal += workload(router.endpoint)
            fleet_s = time.perf_counter() - t0
            rates = [_pool_rate(s) for _, s in reps]
            hits = sum(s.stats()["pool"]["prefix_hits"] for _, s in reps)
            seen = sum(n for _, n in rates)
            pooled = hits / max(1, seen)
            routed = [s.counters["submitted"] for _, s in reps]
            spilled_affinity = router.counters["spilled"]
            router.shutdown()
            router = None
            if single_rate < 0.5 or pooled < 0.9 * single_rate or any(
                    n and r < 0.9 * single_rate for r, n in rates) \
                    or spilled_affinity:
                raise AssertionError(
                    f"F/fleet/inproc: prefix hit rate pooled {pooled}, per "
                    f"replica {rates}, one replica {single_rate}, spilled "
                    f"{spilled_affinity}")

            # spill: replica 0's loop stopped, so the three requests queued
            # on it cannot drain before the scrape; every chunk it sends
            # is delayed 0.1 s by the proxy
            srv0, sched0 = reps[0]
            sched0.close()
            chaos = ChaosProxy(srv0.endpoint, delay_rate=1.0,
                               delay_s=0.1).start()
            router = fleet.FleetRouter([chaos.endpoint, reps[1][0].endpoint],
                                       spill_threshold=1).start()
            holders = [sched0.submit(feed(700 + i),
                                     cfg["max_len"] - cfg["prefix_len"] - 1,
                                     eos_id=-1) for i in range(3)]
            router.scrape_all()
            depth = router.replicas[0].queue_depth
            before = reps[1][1].counters["submitted"]
            admitted = sched0.counters["admitted"]
            cli = _fleet_client(router.endpoint)
            try:
                toks, status = cli.generate(target, FL_INPROC_TOKENS,
                                            eos_id=1)
            finally:
                cli.close()
            spilled = router.counters["spilled"]
            if depth != 3 or not spilled or status != "done" \
                    or reps[1][1].counters["submitted"] != before + 1 \
                    or sched0.counters["admitted"] != admitted:
                raise AssertionError(
                    f"F/fleet/inproc: no spill (depth {depth}, spilled "
                    f"{spilled}, {status})")
            equal += 1 - _diverged("F/fleet/inproc spill", 0, toks.tolist(),
                                   want_target)
            for h in holders:
                h.cancel()
            sched0.start()
            for h in holders:
                h.result(timeout=FL_TIMEOUT_S)
            router.shutdown()
            router = None
            chaos.stop()

            # a stream dropped after its 2nd token, resubmitted by the
            # client under the same request id
            chaos = ChaosProxy(reps[1][0].endpoint).start()
            cli = _fleet_client(chaos.endpoint, call_timeout=10.0,
                                backoff_base=0.02, seed=0)
            seen_toks = []

            def on_tok(t):
                seen_toks.append(int(t))
                if len(seen_toks) == 2:
                    chaos.drop_next(1)

            sub0 = reps[1][1].counters["submitted"]
            dedup0 = reps[1][1].counters["dedup_hits"]
            try:
                toks, status = cli.generate(dropped, FL_INPROC_TOKENS,
                                            eos_id=1, on_token=on_tok)
            finally:
                cli.close()
            if status != "done" or seen_toks != toks.tolist() \
                    or not chaos.counters["dropped_conns"]:
                raise AssertionError(
                    f"F/fleet/inproc: dropped stream {status}, on_token "
                    f"{seen_toks}, tokens {toks.tolist()}")
            resubmits = (reps[1][1].counters["dedup_hits"] - dedup0,
                         reps[1][1].counters["submitted"] - sub0)
            equal += 1 - _diverged("F/fleet/inproc drop", 0, toks.tolist(),
                                   want_dropped)
            _wait_for(lambda: all(s.idle() for _, s in pairs))
    finally:
        if router is not None:
            router.shutdown()
        if chaos is not None:
            chaos.stop()
        for srv, sched in pairs:
            srv.shutdown()
            sched.close()
    requests = 2 * FL_ROUNDS * FL_GROUPS + 2
    res = {"phase": "F/fleet/inproc", "replicas": 3,
           "warm_s": warm_s, "fleet_s": fleet_s,
           "prefix_hit_rate_single": single_rate,
           "prefix_hit_rate_pooled": pooled,
           "prefix_hit_rate_per_replica": [r for r, _ in rates],
           "routed_per_replica": routed,
           "spill_queue_depth": depth, "spilled": spilled,
           "drop_dedup_hits_and_submits": resubmits,
           "dropped_conns": chaos.counters["dropped_conns"],
           "launches": counted.counts, "steps": counted.steps,
           "requests": requests, "requests_equal_to_sequential": equal,
           "card": card}
    log(f"  F/fleet/inproc: 3 replicas (private scopes, startups on the "
        f"card) at transformer-base width, {FL_GROUPS} prompt groups x "
        f"{FL_ROUNDS} rounds of {FL_INPROC_TOKENS} tokens: prefix hit rate "
        f"pooled {pooled:.4f} vs one replica {single_rate:.4f} (per "
        f"replica {[round(r, 4) for r, _ in rates]}, requests {routed}); "
        f"the fleet's 16 requests {fleet_s:.3f} s; a stalled replica with "
        f"queue depth {depth} spilled {spilled}; a stream dropped after 2 "
        f"tokens resubmitted (dedup hits, submits {resubmits}); "
        f"{equal}/{requests} requests equal the sequential Generator  "
        f"[{card}]")
    log(f"    {counted.steps} decode steps, launches {counted.counts}; "
        f"warm-up of 4 replicas {warm_s:.1f} s")
    return res, counted.counts


def _diverged(phase, request, got, want):
    """1 and a DIVERGED entry if `got` differs from `want`, else 0."""
    if got == want:
        return 0
    t = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    DIVERGED.append({"phase": phase, "request": request, "step": t,
                     "got": got[t] if t < len(got) else None,
                     "want": want[t] if t < len(want) else None})
    log(f"    DIVERGED {DIVERGED[-1]}")
    return 1


def _warm_over_wire(endpoint, feed, buckets, seed0, rounds=3):
    """Every bucket of a replica process warmed through its own clients
    before a router sees it: for each bucket b, `rounds` rounds of b
    client threads submitting at once (2 tokens each), so that the
    prefill groups and decode steps reach each bucket's signatures twice
    (an eager run, then a capture).  Returns the seconds taken."""
    t0 = time.perf_counter()
    seed = seed0
    for _ in range(rounds):
        for b in buckets:
            errs = []

            def one(s):
                cli = _fleet_client(endpoint)
                try:
                    cli.generate(feed(s), 2, eos_id=-1)
                except Exception as e:  # noqa: BLE001 — raised below
                    errs.append(repr(e))
                finally:
                    cli.close()

            ts = [threading.Thread(target=one, args=(seed + i,))
                  for i in range(b)]
            seed += b
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            if errs:
                raise AssertionError(f"warm-up over the wire: {errs}")
    return time.perf_counter() - t0


def _card_used_mib():
    """The whole card's used memory in MiB (nvidia-smi memory.used): every
    process's contexts, allocators and graph pools together."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])


def _compute_apps_mib():
    """{pid: MiB} of the card's compute processes, from nvidia-smi (the
    parent cannot read a child's allocator); {} where it lists none."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout
    apps = {}
    for line in out.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            try:
                apps[int(parts[0])] = float(parts[1])
            except ValueError:
                pass
    return apps


def phase_fleet(card):
    """F/fleet: bench.py's fleet leg (bench.py:1946-2228) over replica
    processes on the card (`spawn_replica({"model": "base"})`, each pinned
    to one of partition_cpus(4)'s cpusets and warmed over the wire before
    a router sees it): weak scaling at 1, 2 and 4 replicas (closed loop,
    2 clients a replica; the explicit warm-up stands in for bench.py's
    warm leg), a rolling v1 -> v2 deploy under load (its swap hook kills
    the drained process, spawns and warms the new one; the load runs until
    the deploy ends), and a `kill -9` of replica 0 after the 2nd token of
    a stream affine to it.  Every token of every leg against the parent's
    sequential Generator, whose startup also ran on the card."""
    from paddle_tpu_torch import fleet
    from paddle_tpu_torch.fleet import replica
    from paddle_tpu_torch.parallel import partition_cpus

    cfg, spec, gen, vocab, n_layer = _fleet_model()
    buckets = [1]
    while buckets[-1] < cfg["max_batch"]:
        buckets.append(min(2 * buckets[-1], cfg["max_batch"]))

    def feed(seed):
        return _bench_feed(vocab, cfg["src_len"], cfg["prefix_len"], seed)

    pool = [feed(100 + i) for i in range(FL_POOL)]
    refs = [gen.generate(f, FL_TOKENS, eos_id=1)[0].tolist() for f in pool]
    cpusets = partition_cpus(4)
    procs, eps, timing = {}, {}, {}
    lock = threading.Lock()

    def launch(index, version="v1"):
        """Spawn replica `index` and warm it over the wire; its endpoint."""
        t0 = time.perf_counter()
        proc, ep = replica.spawn_replica(
            dict(cfg, version=version), timeout_s=FL_SPAWN_S,
            cpus=cpusets[index % len(cpusets)])
        with lock:
            procs[index], eps[index] = proc, ep
        t1 = time.perf_counter()
        warm_s = _warm_over_wire(ep, feed, buckets, 9000 + 100 * index)
        with lock:
            timing[(index, version)] = {"start_s": t1 - t0,
                                        "warm_s": warm_s}
        return ep

    def loadavgs(router):
        out = {}
        for rep in router.replicas:
            if rep.state == "down":
                continue
            try:
                out[rep.index] = fleet.probe(rep.endpoint,
                                             timeout=5.0).get("loadavg")
            except (OSError, ConnectionError):
                out[rep.index] = None
        return out

    def card_mib():
        apps = _compute_apps_mib()
        return {i: apps.get(p.pid) for i, p in procs.items()
                if p.poll() is None}

    served = {"n": 0, "equal": 0}
    slock = threading.Lock()

    def check(gi, toks, status, label):
        if status != "done":
            raise AssertionError(f"{label}: a request {status}")
        with slock:
            served["n"] += 1
            served["equal"] += 1 - _diverged(label, gi, toks.tolist(),
                                             refs[gi])

    def leg(router, n_clients, label, seed0, stop=None):
        """Closed loop: n_clients threads, FL_PER_CLIENT requests each
        off the shared pool (and on until `stop` is set, if given).
        Starts the threads; finish() joins them -> (qps, p50, p99, n)."""
        lats, errs = [], []

        def worker(tid):
            r = np.random.RandomState(seed0 + tid)
            cli = _fleet_client(router.endpoint)
            try:
                n = 0
                while n < FL_PER_CLIENT or (stop is not None
                                            and not stop.is_set()):
                    gi = int(r.randint(0, len(pool)))
                    t0 = time.perf_counter()
                    toks, status = cli.generate(pool[gi], FL_TOKENS,
                                                eos_id=1)
                    with slock:
                        lats.append(time.perf_counter() - t0)
                    check(gi, toks, status, label)
                    n += 1
            except Exception as e:  # noqa: BLE001 — fails the leg
                with slock:
                    errs.append(repr(e))
            finally:
                cli.close()

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_clients)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()

        def finish():
            for t in threads:
                t.join(timeout=600)
                if t.is_alive():
                    raise AssertionError(f"{label}: a client is stuck")
            wall = time.perf_counter() - t_start
            if errs:
                raise AssertionError(f"{label}: client errors {errs[:3]}")
            ms = 1e3 * np.asarray(lats)
            return (len(lats) / wall, float(np.percentile(ms, 50)),
                    float(np.percentile(ms, 99)), len(lats))
        return finish

    sweep, router = {}, None
    used0 = _card_used_mib()
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=launch, args=(i,))
                   for i in range(max(FL_SIZES))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if len(timing) != max(FL_SIZES):
            raise AssertionError(f"F/fleet: {len(timing)} of "
                                 f"{max(FL_SIZES)} replicas started")
        start_wall = time.perf_counter() - t0
        used4 = _card_used_mib()
        endpoints = [eps[i] for i in range(max(FL_SIZES))]

        # weak scaling: 1 -> 2 -> 4 replicas, 2 clients a replica
        slo_ms, qps_at_slo = None, 0.0
        for k in FL_SIZES:
            router = fleet.FleetRouter(endpoints[:k]).start()
            qps, p50, p99, n = leg(router, 2 * k, f"F/fleet {k}r",
                                   1000 + 10 * k)()
            if slo_ms is None:   # the 1-replica tier sets the SLO
                slo_ms = 4.0 * p99
            sweep[f"{k}r"] = {
                "replicas": k, "clients": 2 * k, "requests": n, "qps": qps,
                "p50_ms": p50, "p99_ms": p99, "met_slo": p99 <= slo_ms,
                "routed": router.counters["routed"],
                "spilled": router.counters["spilled"],
                "loadavg_per_replica": loadavgs(router),
                "card_mib_per_replica": card_mib()}
            if p99 <= slo_ms and qps > qps_at_slo:
                qps_at_slo = qps
            router.shutdown()
            router = None

        # a rolling v1 -> v2 deploy under load: zero requests dropped
        router = fleet.FleetRouter(endpoints[:2]).start()
        swaps = {}

        def swap(index, old_ep):
            t0 = time.perf_counter()
            procs[index].kill()   # drained: nothing left in flight
            procs[index].wait()
            ep = launch(index, version="v2")
            swaps[index] = {"swap_s": time.perf_counter() - t0,
                            **timing[(index, "v2")]}
            return ep

        stop = threading.Event()
        before = served["n"]
        finish = leg(router, 2, "F/fleet deploy", 2000, stop=stop)
        try:
            rec = fleet.RollingDeploy(router, swap, drain_grace_s=5.0,
                                      expect_version="v2").run()
        finally:
            stop.set()
        _, _, _, n_deploy = finish()
        if served["n"] - before != n_deploy \
                or any(r.version != "v2" for r in router.replicas):
            raise AssertionError(f"F/fleet deploy: {n_deploy} requests, "
                                 f"{served['n'] - before} served")
        for r in rec["replicas"]:
            s = swaps[r["index"]]
            r["start_ms"] = 1e3 * s["start_s"]
            r["warm_ms"] = 1e3 * s["warm_s"]
            r["readmit_ms"] = r["cutover_ms"] - 1e3 * s["swap_s"]
        deploy = {"total_ms": rec["total_ms"],
                  "max_mttr_ms": rec["max_mttr_ms"],
                  "requests": n_deploy, "dropped_requests": 0,
                  "forced_moves": sum(r["forced_moves"]
                                      for r in rec["replicas"]),
                  "replicas": rec["replicas"],
                  "epoch": router.table.epoch}

        # kill -9 of replica 0 after the 2nd token of a stream affine to it
        target = None
        for seed in range(3000, 3512):
            if router.affine_index(feed(seed), 1, None) == 0:
                target = feed(seed)
                break
        want = gen.generate(target, FL_TOKENS, eos_id=1)[0].tolist()
        seen, killed = [], []

        def on_tok(tok):
            seen.append(int(tok))
            if len(seen) == 2:
                procs[0].kill()
                killed.append(time.perf_counter())

        e0, r0 = router.counters["ejections"], router.counters["resubmitted"]
        cli = _fleet_client(router.endpoint)
        try:
            t0 = time.perf_counter()
            toks, status = cli.generate(target, FL_TOKENS, eos_id=1,
                                        on_token=on_tok)
            t1 = time.perf_counter()
        finally:
            cli.close()
        if status != "done" or seen != toks.tolist() or not killed:
            raise AssertionError(f"F/fleet kill: {status}, on_token {seen}, "
                                 f"tokens {toks.tolist()}")
        equal_kill = 1 - _diverged("F/fleet kill", 0, toks.tolist(), want)
        kill = {"recovered_in_s": t1 - t0,
                "after_kill_s": t1 - killed[0],
                "ejections": router.counters["ejections"] - e0,
                "resubmitted": router.counters["resubmitted"] - r0,
                "replica0": router.replicas[0].state,
                "bitwise_after_failover": bool(equal_kill)}
        if kill["ejections"] < 1 or kill["resubmitted"] < 1 \
                or procs[0].wait(timeout=30) != -9:
            raise AssertionError(f"F/fleet kill: {kill}")
        router.shutdown()
        router = None
    finally:
        if router is not None:
            router.shutdown()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    left = [p.pid for p in procs.values() if p.poll() is None]
    if left:
        raise AssertionError(f"F/fleet: replica processes {left} outlive "
                             f"the phase")
    first, last = f"{FL_SIZES[0]}r", f"{FL_SIZES[-1]}r"
    scaling = sweep[last]["qps"] / sweep[first]["qps"]
    res = {"phase": "F/fleet", "new_tokens": FL_TOKENS,
           "requests_per_client": FL_PER_CLIENT, "prompt_pool": FL_POOL,
           "replica_cpusets": cpusets, "start_wall_s": start_wall,
           "card_used_mib_before_and_with_replicas": [used0, used4],
           "card_mib_per_replica_mean": (used4 - used0) / max(FL_SIZES),
           "replica_start_and_warm_s": {f"{i}{v}": t
                                        for (i, v), t in timing.items()},
           "weak_scaling": sweep, "scaling_x": scaling, "slo_ms": slo_ms,
           "qps_at_slo": qps_at_slo, "deploy": deploy, "kill": kill,
           "requests": served["n"] + 1,
           "requests_equal_to_sequential": served["equal"] + equal_kill,
           "card": card}
    log(f"  F/fleet: {max(FL_SIZES)} replica processes (transformer-base, "
        f"startups on the card, cpusets {cpusets}) started and warmed over "
        f"the wire in {start_wall:.1f} s wall, the card's used memory "
        f"{used0:.0f} -> {used4:.0f} MiB "
        f"({res['card_mib_per_replica_mean']:.0f} MiB a replica); weak "
        f"scaling "
        f"{first} -> {last} {scaling:.3f}x, QPS at SLO {slo_ms:.1f} ms "
        f"(4 x the 1-replica p99): {qps_at_slo:.2f}  [{card}]")
    for k, v in sweep.items():
        log(f"    {k}: {v['clients']} clients, {v['requests']} requests, "
            f"{v['qps']:.2f} req/s, p50 {v['p50_ms']:.1f} ms, p99 "
            f"{v['p99_ms']:.1f} ms, met SLO {v['met_slo']}, spilled "
            f"{v['spilled']}; loadavg {v['loadavg_per_replica']}; card MiB "
            f"{v['card_mib_per_replica']}")
    log(f"    deploy v1 -> v2 under load: {deploy['requests']} requests, "
        f"0 dropped, total {deploy['total_ms']:.1f} ms, max MTTR "
        f"{deploy['max_mttr_ms']:.1f} ms, forced moves "
        f"{deploy['forced_moves']}; per replica cutover = process start + "
        f"warm-up + readmission: "
        + "; ".join(f"{r['index']}: {r['cutover_ms']:.1f} = "
                    f"{r['start_ms']:.1f} + {r['warm_ms']:.1f} + "
                    f"{r['readmit_ms']:.1f} ms (drain {r['drain_ms']:.1f})"
                    for r in deploy["replicas"]))
    log(f"    kill -9 of replica 0 after the 2nd token: recovered in "
        f"{kill['recovered_in_s']:.3f} s ({kill['after_kill_s']:.3f} s "
        f"after the kill), ejections {kill['ejections']}, resubmits "
        f"{kill['resubmitted']}, bitwise {kill['bitwise_after_failover']}; "
        f"{res['requests_equal_to_sequential']}/{res['requests']} requests "
        f"equal the sequential Generator")
    return res


def phase_disagg(card):
    """F/disagg: bench.py's disagg A/B (bench.py:2231-2490) at
    transformer-base width on the device pool, in process: one open-loop
    Poisson arrival schedule (60% of the monolithic Scheduler's closed-loop
    capacity, every 4th prompt long) through (A) monolithic prefill, (B)
    chunked prefill at DG_CHUNK with the sweep, and (C) a prefill-only
    Scheduler handing each long prompt's KV to a decode Scheduler; then
    the two-tier fleet over the wire (tests/test_disagg.py:387 at full
    width): a prefill replica behind a ChaosProxy and two decode replicas
    (blocks of DG_DECODE_BLOCK) behind a FleetRouter with
    prefill_min_tokens = the prompt window, the prefill replica killed
    halfway.  Every request's tokens against the sequential Generator."""
    from paddle_tpu_torch import CUDAPlace, Scope, decode, fleet, serving
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.resilience import ChaosProxy

    place = CUDAPlace(0)
    specs = {c: decode_spec(transformer.base(), DG_PREFIX, DG_MAX_LEN,
                            src_len=DG_SRC, chunk_len=c) for c in DG_SWEEP}
    spec = specs[DG_CHUNK]
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    scope = Scope()
    gen = decode.Generator(spec, scope=scope, place=place)

    def plen_of(p):
        return DG_LONG if p % 4 == 0 else DG_SHORT

    def mk_feed(p):
        f = _bench_feed(vocab, DG_SRC, DG_PREFIX, 33_000 + int(p))
        f["prefix_lens"] = np.full(1, plen_of(p), np.int64)
        return f

    feeds = [mk_feed(p) for p in range(DG_PROMPTS)]
    refs = [gen.generate(f, DG_TOKENS, eos_id=-1)[0].tolist() for f in feeds]

    def mk_sched(prefill_chunk=None, leg_spec=None, sc=None,
                 block_size=DG_BLOCK, prefix_cache=False):
        # prefix cache off for the A/B: repeated prompts would skip the
        # prefill work the legs compare
        sched = serving.Scheduler(leg_spec or spec, scope if sc is None
                                  else sc, place=place,
                                  max_batch=DG_STREAMS, block_size=block_size,
                                  num_blocks=DG_BLOCKS * DG_BLOCK
                                  // block_size, paged_kv=True,
                                  prefix_cache=prefix_cache,
                                  prefill_chunk=prefill_chunk)
        _warm_buckets(sched, lambda s: feeds[s % DG_PROMPTS])
        _reset_served(sched)
        return sched

    def ttft_ms(h):
        return (h.first_token_t - h.submit_t) * 1e3

    equal = [0, 0]   # equal, served

    def check(label, handles):
        for p, h in handles:
            if h.status != "done":
                raise AssertionError(f"{label}: prompt {p} {h.status} "
                                     f"{h.error}")
            equal[0] += 1 - _diverged(label, p, list(h.tokens), refs[p])
            equal[1] += 1

    counts = {}

    def counted(label, scheds):
        return _Counted(label, scheds, n_layer)

    # capacity and the arrival schedule (bench.py: 60% of the monolithic
    # Scheduler's closed-loop capacity over 24 requests)
    cap = mk_sched()
    with counted("F/disagg capacity", [cap]) as c:
        t0 = time.perf_counter()
        hs = [(i % DG_PROMPTS, cap.submit(feeds[i % DG_PROMPTS], DG_TOKENS,
                                          eos_id=-1)) for i in range(24)]
        cap.run_until_idle(max_steps=100000)
        capacity = 24 / (time.perf_counter() - t0)
    counts = _add(counts, c.counts)
    check("F/disagg capacity", hs)
    rate = 0.6 * capacity
    n_req = min(150, max(40, int(6.0 * rate)))
    r = np.random.RandomState(77)
    arrivals = np.cumsum(r.exponential(1.0 / rate, size=n_req))
    prompts = r.randint(0, DG_PROMPTS, size=n_req)

    def run_single(sched, label):
        gaps, handles = [], []
        i = 0
        t_start = time.perf_counter()
        while i < n_req or not sched.idle():
            now = time.perf_counter() - t_start
            while i < n_req and arrivals[i] <= now:
                p = int(prompts[i])
                handles.append((p, sched.submit(feeds[p], DG_TOKENS,
                                                eos_id=-1)))
                i += 1
            decoding = len(sched._active) > 0
            ts = time.perf_counter()
            progressed = sched.step()
            if decoding:   # a stall every active decoder paid
                gaps.append((time.perf_counter() - ts) * 1e3)
            if not progressed and i < n_req:
                time.sleep(min(0.001, max(
                    0.0, arrivals[i] - (time.perf_counter() - t_start))))
        wall = time.perf_counter() - t_start
        check(label, handles)
        return gaps, handles, wall

    def leg_stats(gaps, handles, wall, first=lambda h: h):
        longs = [ttft_ms(first(h)) for p, h in handles
                 if plen_of(p) == DG_LONG]
        shorts = [ttft_ms(first(h)) for p, h in handles
                  if plen_of(p) == DG_SHORT]
        return {"decode_pass_p99_ms": float(np.percentile(gaps, 99))
                if gaps else None,
                "decode_pass_max_ms": max(gaps) if gaps else None,
                "ttft_long_p99_ms": float(np.percentile(longs, 99)),
                "ttft_short_p99_ms": float(np.percentile(shorts, 99)),
                "goodput_qps": len(handles) / wall}

    with counted("F/disagg A", [cap]) as c:
        stats_a = leg_stats(*run_single(cap, "F/disagg A"))
    counts = _add(counts, c.counts)
    cap.close()
    sweep = {}
    for chunk in DG_SWEEP:
        sched = mk_sched(prefill_chunk=chunk, leg_spec=specs[chunk])
        with counted(f"F/disagg B chunk {chunk}", [sched]) as c:
            sweep[chunk] = leg_stats(*run_single(sched,
                                                 f"F/disagg B{chunk}"))
            sweep[chunk]["chunk_passes"] = sched.counters["chunk_passes"]
        counts = _add(counts, c.counts)
        if not sched.counters["chunked"]:
            raise AssertionError(f"F/disagg B{chunk}: nothing chunked")
        sched.close()

    # (C) two-tier in process: long prompts prefill on `pre` (chunked) and
    # hand their KV to `dec`
    pre, dec = mk_sched(prefill_chunk=DG_CHUNK), mk_sched()
    with counted("F/disagg C", [pre, dec]) as c:
        pending, handles = [], []
        i = 0
        t_start = time.perf_counter()
        while i < n_req or pending or not (pre.idle() and dec.idle()):
            now = time.perf_counter() - t_start
            while i < n_req and arrivals[i] <= now:
                p = int(prompts[i])
                if plen_of(p) == DG_LONG:   # the router's length detour
                    pending.append((p, pre.submit(feeds[p], DG_TOKENS,
                                                  eos_id=-1,
                                                  prefill_only=True)))
                else:
                    handles.append((p, (None, dec.submit(
                        feeds[p], DG_TOKENS, eos_id=-1))))
                i += 1
            progressed = pre.step() | dec.step()
            still = []
            for p, h in pending:
                if h.status == "prefilled":
                    rec = h.handoff
                    h2 = dec.submit(
                        serving.decode_feed(rec["feed"]),
                        rec["max_new_tokens"], eos_id=rec["eos_id"],
                        bos_id=rec["bos_id"], recorded_tokens=rec["tokens"],
                        kv_payload={"cursor": rec["cursor"],
                                    "rows": rec["kv"],
                                    "states": rec["states"],
                                    "last_tok": rec["last_tok"],
                                    "n_tokens": rec["n_tokens"]})
                    handles.append((p, (h, h2)))  # TTFT on pre, tokens dec
                elif h.done:
                    raise AssertionError(f"F/disagg C: prompt {p} "
                                         f"{h.status}")
                else:
                    still.append((p, h))
            pending = still
            if not progressed and i < n_req:
                time.sleep(min(0.001, max(
                    0.0, arrivals[i] - (time.perf_counter() - t_start))))
        wall_c = time.perf_counter() - t_start
    counts = _add(counts, c.counts)
    check("F/disagg C", [(p, h2) for p, (_, h2) in handles])
    stats_c = leg_stats([], handles, wall_c,
                        first=lambda pair: pair[0] or pair[1])
    stats_c.update(handoffs=pre.counters["handoffs"],
                   adopted=dec.counters["adopted"])
    if not pre.counters["handoffs"] == dec.counters["adopted"] > 0:
        raise AssertionError(f"F/disagg C: {stats_c}")
    pre.close()
    dec.close()

    # the two-tier fleet over the wire: private scopes (startups on the
    # card), the prefill replica behind a ChaosProxy, killed halfway
    pairs, router, chaos, cli = [], None, None, None
    try:
        def server(sched):
            sched.start()
            pairs.append((serving.ServingServer(sched).start(), sched))
            return pairs[-1][0].endpoint

        pre_ep = server(mk_sched(prefill_chunk=DG_CHUNK, sc=Scope(),
                                 prefix_cache=True))
        dec_eps = [server(mk_sched(sc=Scope(), block_size=DG_DECODE_BLOCK,
                                   prefix_cache=True)) for _ in range(2)]
        chaos = ChaosProxy(pre_ep).start()
        router = fleet.FleetRouter(dec_eps, prefill_endpoints=[chaos.endpoint],
                                   prefill_min_tokens=DG_PREFIX).start()
        cli = _fleet_client(router.endpoint)
        wire_ttft = {"up": [], "down": []}
        with counted("F/disagg wire", [s for _, s in pairs]) as c:
            for half in ("up", "down"):
                if half == "down":   # the prefill replica dies
                    pre_sched = pairs[0][1]
                    # every prefill-only request the tier did not hand off
                    not_handed = [
                        (r.status, len(r.tokens), (r.error or "")[-2000:])
                        for r in list(pre_sched._by_rid.values())
                        if r.status != "prefilled"]
                    pre_counters = dict(pre_sched.counters)
                    chaos.set_fault(refuse=True)
                    chaos.kill_connections()
                    pairs[0][0].shutdown()
                    pairs[0][1].close()
                for k in range(DG_WIRE_REQUESTS):
                    p = k if half == "up" else DG_PROMPTS - 1 - k
                    first = []
                    t0 = time.perf_counter()
                    toks, status = cli.generate(
                        feeds[p], DG_TOKENS, eos_id=-1,
                        on_token=lambda t: first or first.append(
                            time.perf_counter()))
                    if status != "done":
                        raise AssertionError(f"F/disagg wire: {status}")
                    wire_ttft[half].append(1e3 * (first[0] - t0))
                    equal[0] += 1 - _diverged(f"F/disagg wire {half}", p,
                                              toks.tolist(), refs[p])
                    equal[1] += 1
            _wait_for(lambda: all(s.idle() for _, s in pairs[1:]))
        counts = _add(counts, c.counts)
        fv = router.fleet_view()
    finally:
        if cli is not None:
            cli.close()
        if router is not None:
            router.shutdown()
        if chaos is not None:
            chaos.stop()
        for srv, sched in pairs:
            srv.shutdown()
            sched.close()
    wc = fv["counters"]
    # every request of the first half handed off (none fell back to a
    # replay on the decode tier), every one of the second fell back
    if wc["prefill_routed"] != DG_WIRE_REQUESTS + 1 \
            or wc["handoffs"] != DG_WIRE_REQUESTS \
            or wc["prefill_fallbacks"] != DG_WIRE_REQUESTS \
            or pre_counters["errors"] or not_handed \
            or fv["prefill_replicas"][0]["state"] != "down":
        raise AssertionError(f"F/disagg wire: {wc}, the prefill tier's "
                             f"counters {pre_counters}, not handed off "
                             f"{not_handed}")
    wire = {k: wc[k] for k in ("prefill_routed", "handoffs",
                               "prefill_fallbacks", "prefill_failovers",
                               "routed", "resubmitted")}
    wire.update(ttft_ms=wire_ttft, dropped_requests=0,
                prefill_tier_counters=pre_counters,
                prefill_tier_not_handed_off=not_handed)
    res = {"phase": "F/disagg", "src_len": DG_SRC, "prefix": DG_PREFIX,
           "long_plen": DG_LONG, "short_plen": DG_SHORT,
           "new_tokens": DG_TOKENS, "max_len": DG_MAX_LEN,
           "streams": DG_STREAMS, "block_size": DG_BLOCK,
           "capacity_qps": capacity, "offered_qps": rate, "n_requests": n_req,
           "single_tier_unchunked": stats_a,
           "single_tier_chunked": sweep[DG_CHUNK],
           "chunk_sweep": {f"chunk={k}": v for k, v in sweep.items()},
           "two_tier": stats_c, "wire": wire, "launches": counts,
           "requests": equal[1], "requests_equal_to_sequential": equal[0],
           "card": card}
    log(f"  F/disagg: capacity {capacity:.2f} req/s (monolithic, closed "
        f"loop), {n_req} Poisson arrivals at {rate:.2f} req/s, every 4th "
        f"prompt {DG_LONG} tokens; decode pass p99 (max) monolithic "
        f"{stats_a['decode_pass_p99_ms']:.3f} "
        f"({stats_a['decode_pass_max_ms']:.3f}) ms, chunked "
        f"{DG_CHUNK} {sweep[DG_CHUNK]['decode_pass_p99_ms']:.3f} "
        f"({sweep[DG_CHUNK]['decode_pass_max_ms']:.3f}) ms; long-prompt "
        f"TTFT p99 monolithic {stats_a['ttft_long_p99_ms']:.2f}, chunked "
        f"{sweep[DG_CHUNK]['ttft_long_p99_ms']:.2f}, two-tier "
        f"{stats_c['ttft_long_p99_ms']:.2f} ms  [{card}]")
    for name, v in [("A monolithic", stats_a)] + [
            (f"B chunk {k}", v) for k, v in sweep.items()] + [
            ("C two-tier", stats_c)]:
        log(f"    {name}: {json.dumps(v)}")
    log(f"    two-tier fleet over the wire: {wire}; "
        f"{equal[0]}/{equal[1]} requests equal the sequential Generator; "
        f"launches {counts}")
    return res, counts


def drive_fleet(card, lap=lambda phase: None):
    """Phase 13: F/fleet/inproc, F/fleet, F/disagg; `lap(phase)` after
    each.  Returns the results and the launches of the counted legs
    (F/fleet's run in the replica processes, where this process cannot
    count them)."""
    res, counts = phase_fleet_inproc(card)
    results = [res]
    torch.cuda.empty_cache()
    lap("[13] F/fleet/inproc")
    results.append(phase_fleet(card))
    torch.cuda.empty_cache()
    lap("[13] F/fleet")
    res, more = phase_disagg(card)
    results.append(res)
    counts = _add(counts, more)
    torch.cuda.empty_cache()
    lap("[13] F/disagg")
    return results, counts


# ---------------------------- [14] the int8 tier and the optimizer tail

# Q/ops: quantized_matmul at transformer-base's decode shapes (8 rows) and a
# 2048-row prefill window; quantized_conv2d at batch 16 on ResNet-50's conv1,
# a 3x3 64->64 at 56, a 1x1 1024->256 at 14 and VGG-19's 3x3 64->64 at 224
Q_MATMULS = (("decode 8x512->512", 8, 512, 512),
             ("decode 8x512->2048", 8, 512, 2048),
             ("decode 8x2048->512", 8, 2048, 512),
             ("decode 8x512->32000", 8, 512, 32000),
             ("prefill 2048x512->512", 2048, 512, 512))
Q_CONVS = (  # (name, input, filter, stride, padding)
    ("ResNet-50 conv1 7x7/2 3->64 at 224", (16, 3, 224, 224), (64, 3, 7, 7),
     2, 3),
    ("3x3 64->64 at 56", (16, 64, 56, 56), (64, 64, 3, 3), 1, 1),
    ("1x1 1024->256 at 14", (16, 1024, 14, 14), (256, 1024, 1, 1), 1, 0),
    ("VGG-19 3x3 64->64 at 224", (16, 64, 224, 224), (64, 64, 3, 3), 1, 1))
PEAK_INT8_OPS = 1979e12       # H100 SXM int8 tensor cores, dense
Q_REPS = 10                   # timed calls a Q/ops case
# I/int8: bench.py's _bench_infer_int8 (bench.py:608-667) at [11]'s batch
# and window; the saved int8 model on the CPU at I_CPU_BATCH: the same
# top-1, logits within Q_CPU_TOL of their largest (a grid value rounds the
# other way where the float path before it differs by an ulp)
INT8_INFER = ("resnet50", "vgg19")
Q_CPU_TOL = 1e-2
# S/int8: bench.py's bench_serving_int8 (bench.py:1611-1725) at
# transformer-base width (bench.py: 128 wide, 2 layers, vocab 4000) and
# bench.py's traffic, TAX_* above; self-agreement floor bench.py's 0.5
S_INT8_SELF_FLOOR = 0.5
S_INT8_PROFILED = 8           # decode steps profiled a tier
# Q/qat and O/tail: MNIST's conv net (models/mnist.py), float32, batch 64
QAT_BATCH, QAT_STEPS, QAT_EVAL = 64, 3, 256
QAT_LR = 1e-3                 # MN at 0.01 diverges on random images
QAT_RTOL = 1e-3               # card vs the port's CPU path
# O/tail's rates: decayed_adagrad, rmsprop and adadelta normalise their
# first step to ~sqrt(1 / (1 - decay)) x lr a weight (adadelta: its
# epsilon sets the step), which at QAT_LR doubles the loss within 2 steps
# on random images; their rates (adadelta's epsilon) go down 10x (100x)
OPT_TAIL = (  # (class, kwargs): the ten update op types of the tail
    ("LarsMomentum", {"learning_rate": QAT_LR, "momentum": 0.9}),
    ("Adagrad", {"learning_rate": QAT_LR}),
    ("Adamax", {"learning_rate": QAT_LR}),
    ("DecayedAdagrad", {"learning_rate": QAT_LR / 10}),
    ("Adadelta", {"learning_rate": QAT_LR, "epsilon": 1e-8}),
    ("RMSProp", {"learning_rate": QAT_LR / 10}),
    ("Ftrl", {"learning_rate": QAT_LR}),
    ("ProximalGD", {"learning_rate": QAT_LR, "l2": 0.01}),
    ("ProximalAdagrad", {"learning_rate": QAT_LR, "l1": 1e-4}),
    ("ModelAverage", {"learning_rate": QAT_LR, "momentum": 0.9}))


def _int8_counts(program):
    """_int_mm calls one run of `program` makes: one a quantized_matmul
    over a 2-D Y, one a group of a quantized_conv2d."""
    n = 0
    for op in program.global_block().ops:
        if op.type == "quantized_matmul":
            n += 1
        elif op.type == "quantized_conv2d":
            n += op.attr("groups", 1) or 1
    return n


def _busy_ms(fn, tries=3):
    """The card's busy ms a call of fn over Q_REPS profiled calls; a trace
    that holds no operation of the card (the profiler sees nothing now and
    then) is taken again, up to `tries`
    times."""
    for _ in range(tries):
        prof = profile_calls(fn, Q_REPS)
        if prof is not None:
            return prof["busy_ms_per_step"]
    return None


def _q_case(timer, name, op_type, inputs, attrs, operands, flop, nbytes,
            library, card):
    """One Q/ops case: the op on the card (its int8 product through
    `_int_mm`) against the same op with the product swapped for its plain
    version (float64, rounded to int32): the int32 accumulators of
    `operands` equal and the outputs bitwise; then the CUDA-event times of
    the op, its plain version and the float32 library call on the
    dequantized values."""
    from paddle_tpu_torch.ops import int8_ops, registry

    info = registry.get_op_info(op_type)
    hook = "int8_matmul" if op_type == "quantized_matmul" else "int8_conv2d"
    real = getattr(int8_ops, hook)
    reference = getattr(int8_ops, hook + "_reference")

    def op():
        return registry.run_forward(info, inputs, attrs,
                                    device=torch.device("cuda", 0))

    def plain():
        setattr(int8_ops, hook, reference)
        try:
            return op()
        finally:
            setattr(int8_ops, hook, real)

    int8_ops.launches = 0
    out = next(iter(op().values()))[0]
    launches = int8_ops.launches
    ref_out = next(iter(plain().values()))[0]
    acc, acc_ref = real(*operands), reference(*operands)
    if not torch.equal(acc, acc_ref) or launches < 1:
        raise AssertionError(f"Q/ops {name}: the int32 accumulators differ "
                             f"(max {(acc - acc_ref).abs().max().item()}), "
                             f"{launches} _int_mm calls")
    err = (out - ref_out).abs().max().item()
    if err != 0.0:
        raise AssertionError(f"Q/ops {name}: output {err} off its plain "
                             "version")
    del acc, acc_ref, out, ref_out
    ms, plain_ms = timer.ms(op), timer.ms(plain)
    library_ms = timer.ms(library)
    # the card's busy time a call, every kernel of it, L2 warm (what a
    # replayed graph pays; the events above also hold the host's eager
    # launches)
    device_ms, library_device_ms = _busy_ms(op), _busy_ms(library)
    bound_ms = max(flop / PEAK_INT8_OPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    row = {"case": name, "op": op_type, "launches": launches,
           "max_abs_err": err, "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_device_ms": library_device_ms, "bound_ms": bound_ms,
           "bound_by": ("operations" if flop / PEAK_INT8_OPS
                        > nbytes / PEAK_BYTES_PER_S else "bytes"),
           "tops": flop / (ms * 1e-3) / 1e12, "flop": flop, "bytes": nbytes,
           "card": card}
    log(f"  Q/ops {name}: int32 equal, max abs err {err}; {ms * 1e3:.1f} us "
        f"by events, card {_us(device_ms)} L2 warm ({row['tops']:.1f} "
        f"TOP/s, "
        f"{launches} _int_mm), plain {plain_ms * 1e3:.1f} us, float32 "
        f"library {library_ms * 1e3:.1f} us (card "
        f"{_us(library_device_ms)}), bound {bound_ms * 1e3:.1f} us "
        f"({row['bound_by']})  [{card}]")
    return row


def phase_q_ops(card, device):
    """Q/ops: each int8 op at its main paths' shapes against its plain
    version on the card, timed with CUDA events, L2 flushed."""
    from paddle_tpu_torch.ops.nn_ops import cudnn_fp32_exact

    timer = Timer(device, reps=Q_REPS)
    rng = np.random.RandomState(SEED + 14)

    def grid(shape, dtype=torch.int8):
        return torch.as_tensor(rng.randint(-127, 128, size=shape),
                               device=device).to(dtype)

    scales = {"Scale": [torch.tensor([0.83], device=device)],
              "WScale": [torch.tensor([0.041], device=device)]}
    q = {"wq_range": 127.0, "aq_range": 127.0}
    rows = []
    for name, m, k, n in Q_MATMULS:
        # X as the program hands it over (float storage of the grid from
        # fake_quantize_abs_max), Y int8 (convert_to_int8's storage)
        x, w = grid((m, k), torch.float32), grid((k, n))
        xi = x.to(torch.int8)
        xf, wf = x * 0.0065, w.float() * 0.0003
        rows.append(_q_case(
            timer, name, "quantized_matmul",
            dict({"X": [x], "Y": [w]}, **scales), dict(q, orig_type="mul"),
            (xi, w), 2 * m * k * n, 4 * m * k + k * n + 4 * m * n,
            lambda xf=xf, wf=wf: torch.matmul(xf, wf), card))
    for name, xs, ws, stride, pad in Q_CONVS:
        x, w = grid(xs, torch.float32), grid(ws)
        xi = x.to(torch.int8)
        geo = ([stride, stride], [pad, pad], [1, 1], 1)
        out_hw = (xs[2] + 2 * pad - ws[2]) // stride + 1
        flop = 2 * xs[0] * ws[0] * out_hw * out_hw * ws[1] * ws[2] * ws[3]
        nbytes = 4 * math.prod(xs) + math.prod(ws) + 4 * xs[0] * ws[0] \
            * out_hw * out_hw
        xf, wf = x * 0.0065, w.float() * 0.0003

        def library(xf=xf, wf=wf, stride=stride, pad=pad):
            with cudnn_fp32_exact():
                return torch.nn.functional.conv2d(xf, wf, None, stride, pad)

        rows.append(_q_case(
            timer, name, "quantized_conv2d",
            dict({"Input": [x], "Filter": [w]}, **scales),
            dict(q, orig_type="conv2d", strides=geo[0], paddings=geo[1]),
            (xi, w) + geo, flop, nbytes, library, card))
        del x, w, xi, xf, wf
        torch.cuda.empty_cache()
    return rows


def phase_infer_int8(name, card):
    """I/int8: bench.py's _bench_infer_int8 on the card.  The model of
    [11] (the same seeded startup, the InferenceTranspiler, _prune), its
    float predictions over I_STEPS batches of I_BATCH taken first (freezing
    bakes the scope), then QuantizeTranspiler -> freeze_int8(as_int8=True)
    -> convert_to_int8 on a clone, timed over the same window on the
    captured jit path; then the int8 program saved and served by a
    Predictor on the card (bitwise the in-process program) and on the CPU
    at I_CPU_BATCH (the same top-1, logits within Q_CPU_TOL)."""
    from paddle_tpu_torch import (CPUPlace, CUDAPlace, Executor, Program,
                                  Scope, io, scope_guard)
    from paddle_tpu_torch.contrib import QuantizeTranspiler, memory_usage
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.ops import int8_ops
    from paddle_tpu_torch.transpiler import InferenceTranspiler

    place = CUDAPlace(0)
    main, startup, prediction = build_infer_model(name)
    infer = main.clone(for_test=True)
    scope = Scope()
    Executor(place).run(startup, scope=scope)
    InferenceTranspiler().transpile(infer, scope=scope)
    infer = infer._prune([prediction])
    logits = _softmax_input(infer, prediction)
    rng = np.random.RandomState(0)
    images = torch.as_tensor(rng.randn(I_STEPS, I_BATCH, 3, R_HW, R_HW)
                             .astype(np.float32), device=place.device)

    def runner(program):
        exe = Executor(place)

        def fwd(x=images[0]):
            return exe.run(program, feed={"img": x},
                           fetch_list=[logits, prediction.name], scope=scope,
                           return_numpy=False)
        return fwd

    def window(fwd):
        """Warm-up (eager, capture), then the timed window: (ms a batch,
        top-1 of every image, card profile of one forward)."""
        for _ in range(I_WARMUP):
            fwd()
        cuda_sync()
        top1 = []
        t0 = time.perf_counter()
        for x in images:
            top1.append(fwd(x)[1].argmax(-1))
        cuda_sync()
        ms = (time.perf_counter() - t0) / I_STEPS * 1e3
        return ms, torch.cat(top1).cpu().numpy(), profile_calls(fwd, 1)

    f_ms, f_top1, f_prof = window(runner(infer))
    f_bytes = memory_usage(infer, I_BATCH)[1]["persistable_bytes"]

    qt = QuantizeTranspiler()
    prog8 = infer.clone(for_test=True)
    qt.training_transpile(prog8, startup_program=Program())
    qt.freeze_int8(prog8, scope, as_int8=True)
    converted = qt.convert_to_int8(prog8, scope)
    per_fwd = _int8_counts(prog8)
    q_bytes = memory_usage(prog8, I_BATCH)[1]["persistable_bytes"]
    fwd8 = runner(prog8)
    int8_ops.launches = 0
    q_ms, q_top1, q_prof = window(fwd8)
    launches = int8_ops.launches
    # the warm-up calls, the window and the profiled call
    if launches != per_fwd * (I_WARMUP + I_STEPS + 1) or not per_fwd:
        raise AssertionError(f"I/int8 {name}: {launches} _int_mm calls, "
                             f"{per_fwd} a forward predicted")
    agree = float(np.mean(q_top1 == f_top1))

    saved = _saved_dir(f"{name}_int8")
    with scope_guard(scope):
        io.save_inference_model(
            saved, ["img"], [prog8.global_block().var(logits),
                             prog8.global_block().var(prediction.name)],
            Executor(place), main_program=prog8)
    pred = create_predictor(Config(saved, place=place))
    in_process = [t.cpu().numpy() for t in fwd8()]
    got = pred.run({"img": images[0]})
    if not pred.quantized or not all(np.array_equal(a, b) for a, b in
                                     zip(got, in_process)):
        raise AssertionError(f"I/int8 {name}: the saved model's Predictor "
                             f"(quantized {pred.quantized}) differs from the "
                             "in-process int8 program")
    small = {"img": images[0][:I_CPU_BATCH].cpu().numpy()}
    on_cpu = create_predictor(Config(saved, place=CPUPlace())).run(small)
    on_card = pred.run(small)
    cpu_err = _rel_err(on_card[0], on_cpu[0])
    same_top1 = bool(np.array_equal(on_card[1].argmax(-1),
                                    on_cpu[1].argmax(-1)))
    if not (same_top1 and cpu_err <= Q_CPU_TOL):
        raise AssertionError(f"I/int8 {name}: card vs CPU Predictor: top-1 "
                             f"equal {same_top1}, logits {cpu_err:.2e} of "
                             "the largest")
    res = {"phase": "I/int8", "model": name, "batch": I_BATCH,
           "images": I_STEPS * I_BATCH, "float_ms_per_batch": f_ms,
           "int8_ms_per_batch": q_ms, "img_per_s": I_BATCH / q_ms * 1e3,
           "float_img_per_s": I_BATCH / f_ms * 1e3,
           "speedup_vs_float": f_ms / q_ms,
           "top1_agreement_vs_float": agree,
           "float_card_ms": f_prof["busy_ms_per_step"] if f_prof else None,
           "int8_card_ms": q_prof["busy_ms_per_step"] if q_prof else None,
           "int8_top_kernels_ms": (q_prof["top_kernels_ms_per_step"]
                                   if q_prof else None),
           "persistable_bytes_float": f_bytes,
           "persistable_bytes_int8": q_bytes, "weights_int8": len(converted),
           "int_mm_per_forward": per_fwd, "int_mm_launches": launches,
           "cpu_max_rel_err": cpu_err, "card": card}
    log(f"  I/int8 {name} batch {I_BATCH}: {res['img_per_s']:.1f} img/s "
        f"({q_ms:.3f} ms/batch, card {res['int8_card_ms']} ms) vs float "
        f"{res['float_img_per_s']:.1f} ({f_ms:.3f} ms/batch, card "
        f"{res['float_card_ms']} ms): x{res['speedup_vs_float']:.3f}; top-1 "
        f"agreement {agree:.4f} over {res['images']} images; persistables "
        f"{f_bytes} -> {q_bytes} bytes ({len(converted)} int8 weights); "
        f"{per_fwd} _int_mm a forward ({launches} counted); saved Predictor "
        f"= in-process bitwise, CPU at batch {I_CPU_BATCH}: same top-1, "
        f"logits {cpu_err:.2e} of the largest  [{card}]")
    log(f"    int8 top kernels (ms): {res['int8_top_kernels_ms']}")
    del pred, scope
    shutil.rmtree(saved, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


def _rate(got, ref):
    n = min(len(got), len(ref))
    return float(np.mean(np.asarray(got[:n]) == np.asarray(ref[:n])))


def phase_serving_int8(card):
    """S/int8: bench.py's bench_serving_int8 at transformer-base width.
    The float tier (a Scheduler on the seeded weights) and the int8 tier
    (build_draft(tier="int8") as the Scheduler's target), each warmed,
    then one timed continuous round of TAX_STREAMS requests; agreement
    with the float sequential Generator, self-agreement with an int8 one;
    #6 and the int8 products counted from the schedulers' steps; card ms a
    decode step of each tier from a profiled window."""
    from paddle_tpu_torch import CUDAPlace, Scope, decode, serving
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import int8_ops

    place = CUDAPlace(0)
    cfg = transformer.base()
    spec = decode_spec(cfg, TAX_PREFIX, TAX_MAX_LEN, src_len=TAX_SRC)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    scope = Scope()
    gen = decode.Generator(spec, scope=scope, place=place)

    def feed(seed):
        return _bench_feed(vocab, TAX_SRC, TAX_PREFIX, seed)

    feeds = [feed(100 + i) for i in range(TAX_STREAMS)]
    refs = [gen.generate(f, TAX_TOKENS, eos_id=-1)[0].tolist()
            for f in feeds]
    spec8, scope8 = transformer.build_draft(
        cfg, src_len=TAX_SRC, prefix_len=TAX_PREFIX, max_len=TAX_MAX_LEN,
        tier="int8", scope=scope)
    n_q = {k: _int8_counts(getattr(spec8, k + "_program"))
           for k in ("prefill", "step")}

    def tier(label, sp, sc):
        sched = serving.Scheduler(sp, sc, place=place, max_batch=TAX_STREAMS)
        _warm_buckets(sched, feed, buckets=[TAX_STREAMS])
        int8_ops.launches = 0
        c0 = dict(sched.counters)
        with _Counted(label, [sched], n_layer) as counted:
            t0 = time.perf_counter()
            rs = [sched.submit(f, TAX_TOKENS, eos_id=-1) for f in feeds]
            sched.run_until_idle(max_steps=100000)
            cuda_sync()
            dt = time.perf_counter() - t0
        int_mm = int8_ops.launches
        steps = sched.counters["steps"] - c0["steps"]
        batches = sched.counters["prefill_batches"] - c0["prefill_batches"]
        if not all(r.status == "done" and len(r.tokens) == TAX_TOKENS
                   for r in rs):
            raise AssertionError(f"{label}: a request not done")
        want = (n_q["step"] * steps + n_q["prefill"] * batches
                if sp is spec8 else 0)
        if int_mm != want:
            raise AssertionError(f"{label}: {int_mm} _int_mm calls, "
                                 f"{want} predicted")
        for f in feeds:   # a profiled window of decode steps
            sched.submit(f, S_INT8_PROFILED + 2, eos_id=-1)
        sched.step()
        prof = profile_calls(sched.step, S_INT8_PROFILED)
        sched.run_until_idle(max_steps=100000)
        sched.pool.assert_quiesced()
        sched.close()
        return {"s": dt, "tokens": [list(r.tokens) for r in rs],
                "launches": counted.counts, "steps": counted.steps,
                "int_mm": int_mm, "prof": prof}

    fl = tier("S/int8 float", spec, scope)
    equal_float = _check_prefixes("S/int8 float", [
        (types.SimpleNamespace(tokens=t), r)
        for t, r in zip(fl["tokens"], refs)])
    q8 = tier("S/int8", spec8, scope8)
    gen8 = decode.Generator(spec8, scope=scope8, place=place)
    refs8 = [gen8.generate(f, TAX_TOKENS, eos_id=-1)[0].tolist()
             for f in feeds]
    agree = float(np.mean([_rate(t, r) for t, r in zip(q8["tokens"], refs)]))
    self_agree = [_rate(t, r) for t, r in zip(q8["tokens"], refs8)]
    if self_agree[0] < S_INT8_SELF_FLOOR:
        raise AssertionError(f"S/int8: the int8 Scheduler diverged from the "
                             f"int8 sequential Generator {self_agree}")
    n_tok = TAX_STREAMS * TAX_TOKENS
    busy = {k: (v["prof"]["busy_ms_per_step"] if v["prof"] else None)
            for k, v in (("float", fl), ("int8", q8))}
    res = {"phase": "S/int8", "d_model": cfg.d_model, "n_layer": n_layer,
           "vocab": vocab, "src_len": TAX_SRC, "prefix": TAX_PREFIX,
           "max_len": TAX_MAX_LEN, "new_tokens": TAX_TOKENS,
           "streams": TAX_STREAMS, "paged_kv": False,
           "float_tokens_per_s": n_tok / fl["s"],
           "int8_tokens_per_s": n_tok / q8["s"],
           "speedup_vs_float": fl["s"] / q8["s"],
           "agreement_vs_float": agree,
           "self_agreement_vs_sequential": self_agree[0],
           "self_agreement_all": float(np.mean(self_agree)),
           "float_equal_to_sequential": equal_float,
           "card_ms_per_decode_step": busy,
           "int8_top_kernels_ms": (q8["prof"]["top_kernels_ms_per_step"]
                                   if q8["prof"] else None),
           "launches_float": fl["launches"], "launches_int8": q8["launches"],
           "steps_float": fl["steps"], "steps_int8": q8["steps"],
           "int_mm": q8["int_mm"], "int_mm_per_step": n_q["step"],
           "card": card}
    log(f"  S/int8 at d_model {cfg.d_model}, {n_layer}+{n_layer} layers, "
        f"vocab {vocab}, {TAX_STREAMS}x{TAX_TOKENS} tokens: int8 "
        f"{res['int8_tokens_per_s']:.1f} tokens/s vs float "
        f"{res['float_tokens_per_s']:.1f} (x{res['speedup_vs_float']:.3f});"
        f" agreement with float {agree:.4f}, self-agreement with a "
        f"sequential int8 Generator {self_agree[0]:.4f} (all "
        f"{res['self_agreement_all']:.4f}); float tier {equal_float}/"
        f"{TAX_STREAMS} equal the sequential Generator; card ms a decode "
        f"step {busy}  [{card}]")
    log(f"    launches float {fl['launches']} ({fl['steps']} steps), int8 "
        f"{q8['launches']} ({q8['steps']} steps), {q8['int_mm']} _int_mm "
        f"({n_q['step']} a step); int8 top kernels "
        f"{res['int8_top_kernels_ms']}")
    counts = _add(fl["launches"], q8["launches"])
    del gen, gen8, scope, scope8
    torch.cuda.empty_cache()
    return res, counts


def phase_v_int8(card, v_trunc):
    """V/int8: phase V with build_draft(tier="int8") as the draft, on a
    freshly seeded transformer-base scope ([5]'s weights); the draft's
    card ms a round beside V/trunc's from [5]."""
    from paddle_tpu_torch import CUDAPlace, Scope, decode
    from paddle_tpu_torch.models import transformer

    scope = Scope()
    decode.Generator(decode_spec(transformer.base(), S_WINDOW, S_MAX_LEN),
                     scope=scope, place=CUDAPlace(0))
    res, counts = phase_v(card, scope, "int8")
    mine = ((res["round_profile"] or {}).get("labels") or {}).get("draft")
    theirs = (((v_trunc or {}).get("round_profile") or {}).get("labels")
              or {}).get("draft")
    res["draft_card_ms_per_round"] = mine and mine["busy_ms_per_call"]
    res["trunc_draft_card_ms_per_round"] = (theirs
                                            and theirs["busy_ms_per_call"])
    log(f"    V/int8 draft card ms a round {res['draft_card_ms_per_round']} "
        f"(6 int8 layers) vs V/trunc's {res['trunc_draft_card_ms_per_round']}"
        f" (3 float layers); acceptance {res['acceptance']:.3f} vs V/trunc's "
        f"{(v_trunc or {}).get('acceptance')}  [{card}]")
    del scope
    torch.cuda.empty_cache()
    return res, counts


def _mnist(opt=None, qat=False):
    """MNIST's conv net (mnist.build_conv), random_seed 1: (main, startup,
    loss, prediction, float test clone, QAT test clone or None, the
    optimizer or ModelAverage)."""
    from paddle_tpu_torch import (Program, optimizer, program_guard,
                                  unique_name)
    from paddle_tpu_torch.contrib import QuantizeTranspiler
    from paddle_tpu_torch.models import mnist

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 1
    cls, kw = opt or ("Momentum", {"learning_rate": QAT_LR,
                                   "momentum": 0.9})
    with program_guard(main, startup), unique_name.guard():
        loss, prediction, _ = mnist.build_conv()
        float_test = main.clone(for_test=True)
        qat_test = None
        if qat:
            QuantizeTranspiler(
                activation_quantize_type="range_abs_max").training_transpile(
                main, startup)
            qat_test = main.clone(for_test=True)
        if cls == "ModelAverage":
            optimizer.Momentum(**kw).minimize(loss)
            made = optimizer.ModelAverage(0.15, min_average_window=2,
                                          max_average_window=4, program=main)
        else:
            made = getattr(optimizer, cls)(**kw)
            made.minimize(loss)
    return main, startup, loss, prediction, float_test, qat_test, made


def _mnist_feed(batch, seed):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(batch, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}


def _card_vs_cpu(phase, main, startup, loss, seed, check=None):
    """QAT_STEPS captured steps on the card and the same steps on the
    port's CPU path from the same weights, losses within QAT_RTOL, and
    `check(card scope, CPU scope)` -> its result; then as many more steps,
    each run by the interpreter and by the graph from the same state
    (JIT_RTOL).  -> (card scope, executor, card losses, CPU losses, the
    check's result, jit losses, interpret losses)."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope

    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    start = _persistables(scope, main)
    feed = _mnist_feed(QAT_BATCH, seed)
    losses, _ = run_steps(exe, main, scope, feed, loss, QAT_STEPS)
    cpu_scope = Scope()
    for name, value in start.items():
        cpu_scope.set_var(name, value.cpu())
    cpu_losses, _ = run_steps(Executor(CPUPlace()), main, cpu_scope, feed,
                              loss, QAT_STEPS)
    if not (np.all(np.isfinite(losses)) and np.allclose(
            losses, cpu_losses, rtol=QAT_RTOL, atol=0)):
        raise AssertionError(f"{phase}: card losses {losses} vs CPU "
                             f"{cpu_losses}")
    checked = check(scope, cpu_scope) if check else None
    jit, ref = jit_vs_interpret(phase, exe, main, scope, feed, loss,
                                QAT_STEPS)
    captured_graphs(phase, exe, feed)
    return scope, exe, losses, cpu_losses, checked, jit, ref


def phase_qat(card):
    """Q/qat: MNIST's conv net through training_transpile(range_abs_max),
    QAT_STEPS captured steps card vs CPU (the range state advancing inside
    the graph: Iter QAT_STEPS and the scale moved off its 1e-3 on both),
    then freeze_int8(as_int8=True) + convert_to_int8, saved, served by a
    Predictor on the card; top-1 agreement with the float test program on
    the trained weights."""
    from paddle_tpu_torch import CUDAPlace, Executor, io, scope_guard
    from paddle_tpu_torch.contrib import QuantizeTranspiler
    from paddle_tpu_torch.inference import Config, create_predictor

    main, startup, loss, prediction, float_test, qat_test, _ = _mnist(
        qat=True)

    def range_state(scope, cpu_scope):
        """Every activation's range_abs_max state after QAT_STEPS steps on
        each side: Iter QAT_STEPS, the scale moved off its 1e-3."""
        state = {}
        for name in [v.name for v in main.list_vars()
                     if v.name.endswith(".iter@state")]:
            act = name[:-len(".iter@state")]
            its = [int(sc.find_var(name).item()) for sc in (scope, cpu_scope)]
            scales = [float(sc.find_var(f"{act}.scale@state").item())
                      for sc in (scope, cpu_scope)]
            if its != [QAT_STEPS] * 2 or any(s == np.float32(1e-3)
                                             for s in scales):
                raise AssertionError(f"Q/qat {act}: Iter {its}, scales "
                                     f"{scales} (card, CPU)")
            state[act] = {"iter": its, "scale": scales}
        if not state:
            raise AssertionError("Q/qat: no range_abs_max state")
        return state

    scope, _, losses, cpu_losses, state, jit, ref = _card_vs_cpu(
        "Q/qat", main, startup, loss, SEED + 15, range_state)
    place = CUDAPlace(0)
    evals = _mnist_feed(QAT_EVAL, SEED + 16)
    float_test = float_test._prune([prediction])
    (f_pred,) = Executor(place).run(float_test, feed={"img": evals["img"]},
                                    fetch_list=[prediction.name],
                                    scope=scope)
    qt = QuantizeTranspiler(activation_quantize_type="range_abs_max")
    qt.freeze_int8(qat_test, scope, as_int8=True)
    converted = qt.convert_to_int8(qat_test, scope)
    saved = _saved_dir("mnist_int8")
    with scope_guard(scope):
        io.save_inference_model(
            saved, ["img"], [qat_test.global_block().var(prediction.name)],
            Executor(place), main_program=qat_test)
    pred = create_predictor(Config(saved, place=place))
    (q_pred,) = pred.run({"img": evals["img"]})
    agree = float(np.mean(q_pred.argmax(-1) == f_pred.argmax(-1)))
    if not pred.quantized:
        raise AssertionError("Q/qat: the saved model is not quantized")
    res = {"phase": "Q/qat", "batch": QAT_BATCH, "steps": QAT_STEPS,
           "lr": QAT_LR, "losses": losses, "cpu_losses": cpu_losses,
           "jit_losses": jit, "interpret_losses": ref, "range_state": state,
           "int8_weights": converted, "eval_images": QAT_EVAL,
           "top1_agreement_vs_float": agree, "card": card}
    log(f"  Q/qat MNIST conv, range_abs_max, batch {QAT_BATCH}: card losses "
        f"{losses}, CPU {cpu_losses}; jit {jit} = interpret {ref}; range "
        f"state {state}; frozen int8 ({len(converted)} int8 weights) served "
        f"by a Predictor on the card: top-1 agreement with the float test "
        f"program {agree:.4f} over {QAT_EVAL} images  [{card}]")
    shutil.rmtree(saved, ignore_errors=True)
    return res


def phase_opt_tail(card):
    """O/tail: each optimizer of the tail on MNIST's conv net, card vs CPU
    and jit vs interpret (_card_vs_cpu); ModelAverage's apply() binds the
    window averages and its exit (and restore() after need_restore=False)
    binds back the live tensors, bitwise."""
    rows = []
    for i, (cls, kw) in enumerate(OPT_TAIL):
        main, startup, loss, _, _, _, made = _mnist((cls, kw))
        types = {op.type for op in main.global_block().ops}
        scope, exe, losses, cpu_losses, _, jit, ref = _card_vs_cpu(
            f"O/tail {cls}", main, startup, loss, SEED + 20 + i)
        row = {"optimizer": cls, "losses": losses, "cpu_losses": cpu_losses,
               "jit_losses": jit, "interpret_losses": ref,
               "update_ops": sorted(types & {
                   "lars_momentum", "adagrad", "adamax", "decayed_adagrad",
                   "adadelta", "rmsprop", "ftrl", "proximal_gd",
                   "proximal_adagrad", "average_accumulates"})}
        if cls == "ModelAverage":
            params = [p.name for p in made._params]
            live = {n: scope.find_var(n) for n in params}
            snap = {n: t.clone() for n, t in live.items()}
            with made.apply(exe, scope=scope):
                moved = sum(not torch.equal(scope.find_var(n), snap[n])
                            for n in params)
            with made.apply(exe, need_restore=False, scope=scope):
                pass
            made.restore(exe)
            if not moved or any(scope.find_var(n) is not live[n]
                                or not torch.equal(live[n], snap[n])
                                for n in params):
                raise AssertionError("O/tail ModelAverage: apply/restore "
                                     "did not give the live parameters back")
            row["averaged_params_moved"] = moved
        if len(row["update_ops"]) != 1:
            raise AssertionError(f"O/tail {cls}: update ops "
                                 f"{row['update_ops']}")
        rows.append(row)
        log(f"  O/tail {cls} ({row['update_ops'][0]}): card {losses}, CPU "
            f"{cpu_losses}; jit {jit} = interpret {ref}"
            + (f"; {row['averaged_params_moved']} averaged params bound and "
               f"restored bitwise" if cls == "ModelAverage" else "")
            + f"  [{card}]")
        del scope, exe
    return {"phase": "O/tail", "batch": QAT_BATCH, "steps": QAT_STEPS,
            "optimizers": rows, "card": card}


def drive_int8(card, device, v_trunc, lap=lambda phase: None):
    """Phase 14: Q/ops, I/int8, S/int8, V/int8, Q/qat, O/tail; `lap(phase)`
    after each.  -> (results, the eight kernels' launches)."""
    results = [{"phase": "Q/ops", "cases": phase_q_ops(card, device),
                "card": card}]
    lap("[14] Q/ops")
    for name in INT8_INFER:
        results.append(phase_infer_int8(name, card))
        lap(f"[14] I/int8 {name}")
    res, counts = phase_serving_int8(card)
    results.append(res)
    lap("[14] S/int8")
    res, more = phase_v_int8(card, v_trunc)
    results.append(res)
    counts = _add(counts, more)
    lap("[14] V/int8")
    results.append(phase_qat(card))
    lap("[14] Q/qat")
    results.append(phase_opt_tail(card))
    lap("[14] O/tail")
    return results, counts


# ------------------------------------------- [15] BERT-base as bench.py runs it

# B/head: bench.py's bench_bert legs (bench.py:293-447): BERT-base at
# dropout 0, bf16 AMP, Adam(1e-4, multi_precision); the headline at seq 512
# batch 64 and its legs at batch max(64 // (S // 512), 4); long_seq_flash
# forces the streaming tier with the flash_attention flag, as bench.py does
BertLeg = collections.namedtuple("BertLeg", ["seq", "batch", "masked",
                                             "flag"])
BERT_LEGS = {
    "headline": BertLeg(512, 64, False, None),
    "masked": BertLeg(512, 64, True, None),
    "long_seq": BertLeg(1024, 32, False, None),
    "long_seq_flash": BertLeg(1024, 32, False, "flash"),
    "long_2048": BertLeg(2048, 16, False, None),
    "long_4096": BertLeg(4096, 8, False, None),
    "long_4096_masked": BertLeg(4096, 8, True, None),
}
BH_WARMUP, BH_STEPS = 2, 3
# every B/head step also fetches the first and the last layer's attention
# output; the first step's must agree with the composite forward's within
# ATTN_TOL of the latter's largest value (bf16: one rounding of the
# output, and the drift of the layers before)
ATTN_TOL = 2e-2
# B/mem: T2's step and the BERT headline's, plain, fused_head=True and
# RecomputeOptimizer over the model's checkpoints, from the same weights;
# the last of their losses (after BH_WARMUP + BH_STEPS - 1 updates) within
# MEM_RTOL_BF16 of the plain run's, which a wrong head or recompute grad
# would pass only by chance.  Then transformer-base at T1's batch and the
# BERT headline at MEM_F32_BERT_BATCH in float32, 3 steps each: remat =
# plain within JIT_RTOL (the same kernels on the same inputs), fused =
# unfused within FUSED_RTOL
MEM_VARIANTS = ("plain", "fused", "remat")
MEM_RTOL_BF16 = 1e-3
MEM_F32_STEPS = 3
MEM_F32_BERT_BATCH = 8
FUSED_RTOL = 1e-4
# O/clip: MNIST's conv net at QAT_BATCH, GradientClipByGlobalNorm(1.0),
# L1Decay(1e-4), Adam over noam_decay(64, 50) or piecewise_decay, 3
# captured steps card vs CPU, then 3 more jit vs interpret
CLIP_NORM, L1_COEFF, CLIP_STEPS = 1.0, 1e-4, 3
CLIP_RTOL = 1e-5
NOAM = (64, 50)
PIECEWISE = ([2, 4], [1e-3, 5e-4, 2e-4])


def _schedule_lr(kind, step):
    """The schedule's rate at `step`, in float64 on the host."""
    if kind == "noam":
        d, w = NOAM
        return d ** -0.5 * min(step ** -0.5, step * w ** -1.5)
    bounds, values = PIECEWISE
    return values[sum(step >= b for b in bounds)]


def _leg_tier(leg, cfg, device):
    """The tier the gate sends the leg's attentions to."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops import attention_ops

    q = torch.empty((leg.batch, leg.seq, cfg.hidden), dtype=torch.bfloat16,
                    device=device)
    prev = flags.get("flash_attention")
    flags.set("flash_attention", leg.flag or prev)
    try:
        return attention_ops._backend_choice(q, q, cfg.heads, False, False,
                                             leg.masked)[0]
    finally:
        flags.set("flash_attention", prev)


def _tier_expect(tier, n_attn, steps):
    """#1 and #2 once an attention and step on the mha_block tier; on the
    flash tier #3 twice (the grad recomputes out and lse), #4 and #5
    once."""
    if tier == "flash":
        return _bert_expect(n_attn, steps)
    if tier != "mha_block":
        raise AssertionError(f"BERT attention on the {tier} tier")
    return {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "mha_block": n_attn * steps,
            "mha_block_bwd": n_attn * steps}


def _composite_forward(main, loss, scope, feed, probe=()):
    """The loss of the program's for_test clone (its forward) on the
    composite tier, run by the interpreter, and the `probe` vars' values:
    each attention's scores die before the next, which a composite
    training step at 4096 tokens (12 layers of [8, 12, 4096, 4096]
    float32 scores kept for the backward) could not hold."""
    from paddle_tpu_torch import CUDAPlace, Executor, flags

    flags.set("flash_attention", "0")
    try:
        v, *values = Executor(CUDAPlace(0), mode="interpret").run(
            main.clone(for_test=True), feed=feed,
            fetch_list=[loss.name] + list(probe), scope=scope,
            return_numpy=False)
    finally:
        flags.reset("flash_attention")
    torch.cuda.empty_cache()
    return float(v.float().reshape(-1)[0]), values


def _seeded_scope(main, startup, start=None):
    """A scope with `startup` run on the card and, with `start`, every
    persistable `start` also holds copied over in place (the same
    weights)."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope

    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    if start is not None:
        mine = {v.name for v in main.list_vars() if v.persistable}
        _restore(scope, {n: v for n, v in start.items() if n in mine})
    return scope, exe


def timed_training(phase, main, loss, scope, exe, feed, tokens_per_step,
                   fpt, card, warmup=BH_WARMUP, steps=BH_STEPS, probe=()):
    """warmup + steps training steps on the jit path (the first eager, the
    second captured, later ones replayed), the counters zeroed and the
    peak-memory window opened before, `probe` fetched at every step;
    -> (the phase's record, the first step's `probe` values)."""
    from paddle_tpu_torch.ops import attention_ops

    cuda_sync()
    _zero_counts()
    attention_ops.TIER_CALLS.clear()
    before = graph_stats()
    reset_peak_memory()
    warm, first = run_steps(exe, main, scope, feed, loss, warmup,
                            probe=probe)
    cuda_sync()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, steps, probe=probe)
    cuda_sync()
    wall = time.perf_counter() - t0
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: losses {losses}")
    graphs, bound = captured_graphs(phase, exe, feed)
    rate = tokens_per_step * steps / wall
    res = {"phase": phase, "warmup": warmup, "steps": steps,
           "losses": losses, "launches": _bert_counts(),
           "tiers": dict(attention_ops.TIER_CALLS),
           "tokens_per_s": rate, "ms_per_step": wall / steps * 1e3,
           "mfu": rate * fpt / PEAK_FLOP_PER_S[torch.bfloat16],
           "flops_per_token": fpt, "graphs": graphs, "bound_args": bound,
           "card": card}
    res.update(capture_fields(before, None, res["ms_per_step"]))
    return res, first


def _attn_err(got, want):
    """Max abs difference over the largest abs value of `want`."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def phase_bert_leg(name, card, device):
    """One of bench.py's BERT legs: the gate's tier and its launches, the
    first loss and the first and last layer's attention outputs against
    the composite's forward, tokens/s, MFU, memory."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import bert

    leg = BERT_LEGS[name]
    cfg = bert.BertConfig(max_positions=leg.seq, dropout=0.0)
    main, startup, loss = build_bert(cfg, True, leg.masked)
    attn = [op.output("Out")[0] for op in main.global_block().ops
            if op.type == "fused_attention"]
    n_attn, probe = len(attn), [attn[0], attn[-1]]
    tier = _leg_tier(leg, cfg, device)
    scope, exe = _seeded_scope(main, startup)
    feed = bert.synthetic_batch(leg.batch, cfg, seed=SEED + 30,
                                use_input_mask=leg.masked)
    feed = {k: torch.as_tensor(v, device=device) for k, v in feed.items()}
    comp_first, comp_attn = _composite_forward(main, loss, scope, feed,
                                               probe)
    prev = flags.get("flash_attention")
    if leg.flag:
        flags.set("flash_attention", leg.flag)
    try:
        res, got_attn = timed_training(
            f"B/head {name}", main, loss, scope, exe, feed,
            leg.batch * leg.seq,    # bench.py:331
            bert_flops_per_token(cfg, leg.seq), card, probe=probe)
    finally:
        flags.set("flash_attention", prev)
    steps = BH_WARMUP + BH_STEPS
    expect = _tier_expect(tier, n_attn, steps)
    if res["launches"] != expect or res["tiers"] != {tier: n_attn * steps}:
        raise AssertionError(f"B/head {name}: launches {res['launches']}, "
                             f"tiers {res['tiers']}; the gate predicts "
                             f"{expect} on {tier}")
    first = res["losses"][0]
    if abs(first - comp_first) > LOSS_RTOL_BF16 * abs(comp_first):
        raise AssertionError(f"B/head {name}: first loss {first} vs the "
                             f"composite forward {comp_first}")
    attn_err = [_attn_err(g, w) for g, w in zip(got_attn, comp_attn)]
    del got_attn, comp_attn
    if not max(attn_err) <= ATTN_TOL:
        raise AssertionError(f"B/head {name}: the first and last layer's "
                             f"attention outputs differ from the composite "
                             f"forward's by {attn_err} of their largest")
    res.update(seq=leg.seq, batch=leg.batch, masked=leg.masked,
               flag=leg.flag, attention_tier=tier,
               composite_first_loss=comp_first,
               attn_err_first_last=attn_err, dtype="bfloat16 AMP")
    if leg.masked:
        res["real_tokens"] = _real_tokens(feed)
    log(f"  B/head {name} S {leg.seq} b{leg.batch}"
        f"{' masked' if leg.masked else ''}: {tier}, "
        f"{res['tokens_per_s']:.1f} tokens/s, {res['ms_per_step']:.2f} "
        f"ms/step, MFU {res['mfu']:.4f}; losses {res['losses']}, composite "
        f"forward {comp_first}; attention outputs, first and last layer, "
        f"vs the composite's {attn_err} of their largest; launches "
        f"{res['launches']}  [{card}]")
    log_capture(f"B/head {name}", res)
    del scope, exe
    torch.cuda.empty_cache()
    return res, res["launches"]


def _mem_variants(model, card, device):
    """B/mem on one model: the plain step, then fused_head and remat from
    the plain run's starting weights; each variant's rate and memory, and
    its last loss within MEM_RTOL_BF16 of the plain run's."""
    from paddle_tpu_torch.models import bert, transformer

    rows, launches = [], {}
    start = feed = None
    for variant in MEM_VARIANTS:
        if model == "T2":
            cfg = transformer.TransformerConfig(max_length=SEQ, dropout=0.0)
            main, startup, loss, _ = build_training(cfg, True, False,
                                                    variant)
            if feed is None:
                feed = _train_feed(cfg, T2_BATCH, SEED + 2, False, device)
            tokens, fpt = 2 * T2_BATCH * SEQ, flops_per_token(cfg)
        else:
            leg = BERT_LEGS["headline"]
            cfg = bert.BertConfig(max_positions=leg.seq, dropout=0.0)
            main, startup, loss = build_bert(cfg, True, False, variant)
            if feed is None:
                feed = {k: torch.as_tensor(v, device=device)
                        for k, v in bert.synthetic_batch(
                            leg.batch, cfg, seed=SEED + 30).items()}
            tokens = leg.batch * leg.seq
            fpt = bert_flops_per_token(cfg, leg.seq)
        scope, exe = _seeded_scope(main, startup, start)
        if start is None:
            start = _persistables(scope, main)
        res, _ = timed_training(f"B/mem {model} {variant}", main, loss,
                                scope, exe, feed, tokens, fpt, card)
        types = [op.type for op in main.global_block().ops]
        res.update(model=model, variant=variant,
                   recompute_clones=sum("@RECOMPUTE@" in n
                                        for op in main.global_block().ops
                                        for n in op.output_arg_names[:1]),
                   rc_barriers=types.count("rc_barrier"),
                   fused_heads=types.count("linear_softmax_ce"))
        if rows:
            plain = rows[0]
            res["peak_mem_saved_mib"] = (plain["peak_mem_mib"]
                                         - res["peak_mem_mib"])
            res["peak_reserved_saved_mib"] = (plain["peak_reserved_mib"]
                                              - res["peak_reserved_mib"])
            res["rate_vs_plain"] = res["tokens_per_s"] / plain["tokens_per_s"]
            res["last_loss_rel"] = (abs(res["losses"][-1]
                                        - plain["losses"][-1])
                                    / abs(plain["losses"][-1]))
            if not res["last_loss_rel"] <= MEM_RTOL_BF16:
                raise AssertionError(f"B/mem {model} {variant}: last loss "
                                     f"{res['losses'][-1]} vs plain "
                                     f"{plain['losses'][-1]}")
        rows.append(res)
        launches = _add(launches, res["launches"])
        log(f"  B/mem {model} {variant}: {res['tokens_per_s']:.1f} tokens/s, "
            f"{res['ms_per_step']:.2f} ms/step; peak "
            f"{res['peak_mem_mib']:.0f} MiB allocated, "
            f"{res['peak_reserved_mib']:.0f} reserved, graph pool "
            f"{res['graph_pool_mib']:.0f}"
            + (f"; saves {res['peak_mem_saved_mib']:.0f} MiB allocated, "
               f"{res['peak_reserved_saved_mib']:.0f} reserved, rate x"
               f"{res['rate_vs_plain']:.3f}, last loss vs plain "
               f"{res['last_loss_rel']:.2e}" if len(rows) > 1 else "")
            + f"; losses {res['losses']}  [{card}]")
        del scope, exe
        torch.cuda.empty_cache()
    return rows, launches


def _mem_f32(model, card, device):
    """transformer-base at T1's batch ("T1") or the BERT headline at
    MEM_F32_BERT_BATCH ("BERT") in float32, 3 jit steps each from the same
    weights: remat equals plain within JIT_RTOL, fused within FUSED_RTOL."""
    from paddle_tpu_torch.models import bert, transformer

    if model == "T1":
        cfg = transformer.TransformerConfig(max_length=SEQ, dropout=0.0)
        feed = _train_feed(cfg, T1_BATCH, SEED + 31, False, device)
        batch, seq = T1_BATCH, SEQ
    else:
        leg = BERT_LEGS["headline"]
        cfg = bert.BertConfig(max_positions=leg.seq, dropout=0.0)
        feed = {k: torch.as_tensor(v, device=device)
                for k, v in bert.synthetic_batch(
                    MEM_F32_BERT_BATCH, cfg, seed=SEED + 32).items()}
        batch, seq = MEM_F32_BERT_BATCH, leg.seq
    losses, start = {}, None
    for variant in MEM_VARIANTS:
        if model == "T1":
            main, startup, loss, _ = build_training(cfg, False, False,
                                                    variant)
        else:
            main, startup, loss = build_bert(cfg, False, False, variant)
        scope, exe = _seeded_scope(main, startup, start)
        if start is None:
            start = _persistables(scope, main)
        losses[variant], _ = run_steps(exe, main, scope, feed, loss,
                                       MEM_F32_STEPS)
        del scope, exe
        torch.cuda.empty_cache()
    plain = losses["plain"]
    if not (np.all(np.isfinite(plain))
            and np.allclose(losses["remat"], plain, rtol=JIT_RTOL, atol=0)
            and np.allclose(losses["fused"], plain, rtol=FUSED_RTOL,
                            atol=0)):
        raise AssertionError(f"B/mem float32 {model}: losses {losses}")
    res = {"phase": f"B/mem f32 {model}", "batch": batch, "seq": seq,
           "steps": MEM_F32_STEPS, "losses": losses,
           "remat_max_rel": max(abs(a - b) / abs(b) for a, b in
                                zip(losses["remat"], plain)),
           "fused_max_rel": max(abs(a - b) / abs(b) for a, b in
                                zip(losses["fused"], plain)),
           "card": card}
    log(f"  B/mem float32 {model} batch {batch} seq {seq}: losses {losses}; "
        f"remat vs plain {res['remat_max_rel']:.2e}, fused vs unfused "
        f"{res['fused_max_rel']:.2e}  [{card}]")
    return res


def _mnist_clip(kind):
    """MNIST's conv net with a global-norm clip, L1 decay and Adam over a
    learning-rate schedule: (main, startup, loss, the rate var)."""
    from paddle_tpu_torch import (Program, clip, layers, optimizer,
                                  program_guard, regularizer, unique_name)
    from paddle_tpu_torch.models import mnist

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 1
    with program_guard(main, startup), unique_name.guard():
        loss, _, _ = mnist.build_conv()
        clip.set_gradient_clip(clip.GradientClipByGlobalNorm(CLIP_NORM))
        lr = (layers.noam_decay(*NOAM) if kind == "noam"
              else layers.piecewise_decay(*PIECEWISE))
        optimizer.Adam(lr, regularization=regularizer.L1Decay(
            L1_COEFF)).minimize(loss)
    return main, startup, loss, lr


def _steps_with_lr(exe, main, scope, feed, loss, lr, n):
    """n steps: [(loss, rate)] and the counter after."""
    from paddle_tpu_torch.layers.learning_rate_scheduler import \
        LR_COUNTER_NAME

    out = []
    for _ in range(n):
        lv, rv = exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope,
                         return_numpy=False)
        out.append((float(lv.float().reshape(-1)[0]),
                    float(rv.float().reshape(-1)[0])))
    return out, int(scope.find_var(LR_COUNTER_NAME).reshape(-1)[0])


def phase_o_clip(card):
    """O/clip: CLIP_STEPS captured steps on the card against the port's CPU
    path from the same weights (losses within CLIP_RTOL, the rates
    equal), the rate fetched after each replay the schedule's at that
    step; then CLIP_STEPS more, each run by the interpreter and by the
    graph from the same state, equal exactly; the counter follows."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope
    from paddle_tpu_torch.framework.executor import _RNG_COUNTER_NAME

    rows = []
    for i, kind in enumerate(("noam", "piecewise")):
        main, startup, loss, lr = _mnist_clip(kind)
        types = [op.type for op in main.global_block().ops]
        scope, exe = Scope(), Executor(CUDAPlace(0))
        exe.run(startup, scope=scope)
        start = _persistables(scope, main)
        feed = _mnist_feed(QAT_BATCH, SEED + 40 + i)
        card_run, counter = _steps_with_lr(exe, main, scope, feed, loss, lr,
                                           CLIP_STEPS)
        cpu_scope = Scope()
        for name, value in start.items():
            cpu_scope.set_var(name, value.cpu())
        cpu_run, _ = _steps_with_lr(Executor(CPUPlace()), main, cpu_scope,
                                    feed, loss, lr, CLIP_STEPS)
        losses = [l for l, _ in card_run]
        cpu_losses = [l for l, _ in cpu_run]
        rates = [r for _, r in card_run]
        want = [_schedule_lr(kind, s) for s in range(1, CLIP_STEPS + 1)]
        if not (np.all(np.isfinite(losses))
                and np.allclose(losses, cpu_losses, rtol=CLIP_RTOL, atol=0)
                and rates == [r for _, r in cpu_run]
                and np.allclose(rates, want, rtol=1e-6, atol=0)
                and counter == CLIP_STEPS):
            raise AssertionError(
                f"O/clip {kind}: card {card_run} vs CPU {cpu_run}; rates "
                f"{rates} vs the schedule {want}; counter {counter}")
        eager = Executor(CUDAPlace(0), mode="interpret")
        jit, ref = [], []
        for _ in range(CLIP_STEPS):
            scratch = Scope()
            for name, value in _persistables(scope, main).items():
                scratch.set_var(name, value)
            scratch.set_var(_RNG_COUNTER_NAME,
                            scope.find_var(_RNG_COUNTER_NAME))
            ref += _steps_with_lr(eager, main, scratch, feed, loss, lr,
                                  1)[0]
            step, counter = _steps_with_lr(exe, main, scope, feed, loss, lr,
                                           1)
            jit += step
        if jit != ref or counter != 2 * CLIP_STEPS:
            raise AssertionError(f"O/clip {kind}: jit {jit} vs interpret "
                                 f"{ref}; counter {counter}")
        captured_graphs(f"O/clip {kind}", exe, feed)
        rows.append({"schedule": kind, "losses": losses,
                     "cpu_losses": cpu_losses, "rates": rates,
                     "schedule_rates": want, "jit": jit, "interpret": ref,
                     "counter": counter,
                     "ops": {t: types.count(t) for t in (
                         "increment", "lr_schedule", "squared_l2_norm",
                         "sqrt", "elementwise_max", "elementwise_div",
                         "sign", "adam")}})
        log(f"  O/clip {kind}: card {losses}, CPU {cpu_losses}; rates "
            f"{rates} (schedule {want}); jit {jit} = interpret {ref}; "
            f"counter {counter}  [{card}]")
        del scope, exe, cpu_scope
    return {"phase": "O/clip", "batch": QAT_BATCH, "clip_norm": CLIP_NORM,
            "l1": L1_COEFF, "runs": rows, "card": card}


def drive_bert_tail(card, device, lap=lambda phase: None):
    """Phase 15: B/head (bench.py's seven BERT legs), B/mem (T2's and the
    BERT headline's step plain, fused and remat, and the float32 checks),
    O/clip; `lap(phase)` after each.  -> (results, the eight kernels'
    launches)."""
    results, launches = [], {}
    for name in BERT_LEGS:
        res, counts = phase_bert_leg(name, card, device)
        results.append(res)
        launches = _add(launches, counts)
        lap(f"[15] B/head {name}")
    for model in ("T2", "BERT"):
        rows, counts = _mem_variants(model, card, device)
        results += rows
        launches = _add(launches, counts)
        lap(f"[15] B/mem {model}")
    for model in ("T1", "BERT"):
        results.append(_mem_f32(model, card, device))
        lap(f"[15] B/mem f32 {model}")
    results.append(phase_o_clip(card))
    lap("[15] O/clip")
    return results, launches


# ------------------------- [16] the sparse tier and the checkpoint manager

# CTR: bench.py's ctr_deepfm leg (bench.py:2493-2569): DeepFM at batch
# 4096, 26 fields over 10^5 ids, embedding 10, 13 dense features, MLP
# 400-400-400 under Adam(1e-3), random seed 1; its two services (the
# embeddings and the first-order weights) hold 2 adagrad shards each in
# host memory.  The first CTR_CHECK_STEPS steps (eager, captured, replayed)
# are checked against the port's CPU path and warm the step up; one more
# is run by the interpreter and the graph; then CTR_STEPS timed steps
# with `run` and CTR_STEPS with `run_pipelined`, CTR_PROFILED profiled
CTR_BATCH, CTR_FIELDS, CTR_IDS = 4096, 26, int(1e5)
CTR_EMB, CTR_DENSE, CTR_MLP = 10, 13, (400, 400, 400)
CTR_CHECK_STEPS, CTR_STEPS, CTR_PROFILED = 3, 20, 2
CTR_RTOL, CTR_ROW_ATOL = 1e-4, 1e-5     # card vs CPU: losses, touched rows
# A hidden unit whose pre-activation lies within float32 rounding of 0
# can take the other side of the ReLU on the card than on the CPU: that
# example's row grads then move by the unit's share (a few % of them),
# and adagrad's first update, lr g / |g|, passes that on to its 26 rows
# whole (up to ~5e-4 at lr 0.01).  An example whose row grads differ by
# more than CTR_KINK of its largest is flagged; at most CTR_KINK_MAX a
# step may be (0.1% of the batch).  A flagged example's rows are held to
# CTR_KINK_ROW_ATOL (a wrong direction moves a row by ~lr = 1e-2) only
# where the witness shows the flip: the step is run again on both sides,
# its ReLUs' pre-activations fetched, and the first layer where the
# example's signs differ must differ only by a rounding gap (no larger
# than the card-vs-CPU spread of that layer over the unflagged
# examples).  Every other row is held to CTR_ROW_ATOL
CTR_KINK, CTR_KINK_MAX, CTR_KINK_ROW_ATOL = 1e-3, 4, 1e-3
# a shard server must add less than this to the card's used memory (a
# CUDA context takes hundreds of MiB)
SERVER_CARD_MIB = 64
# CTR/resume: RESUME_STEPS sync steps with a CheckpointManager save after
# step RESUME_AT; the later steps again from it, in a fresh scope with
# fresh services
RESUME_STEPS, RESUME_AT = 6, 3
# CTR/remote: bench.py's recovery protocol (bench.py:2572-2689) on the
# model, its embeddings over 2 shard-server processes under a
# ShardSupervisor; a shard checkpoint before step REMOTE_CKPT_AT, kill -9
# of shard 1 before step REMOTE_KILL_AT (steps counted from 0)
REMOTE_STEPS, REMOTE_CKPT_AT, REMOTE_KILL_AT = 12, 4, 6
# SP/reshard: bench.py's reshard leg (bench.py:2837-2986): prefetch and
# push of 512 x 26 ids at dim 10 over 1, 2, 4 and 8 shard servers (sgd,
# lr 0.05), then a live 2 -> 4 reshard under load
RS_DIM, RS_FIELDS, RS_BATCH, RS_STEPS = 10, 26, 512, 20
RS_SHARDS = (1, 2, 4, 8)
# the live reshard's loop steps until 5 steps after the reshard ended
# (bench.py stops at 500 steps, which at ~13 ms a step on the card's host
# ends before the cutover), within RS_LOOP_S seconds
RS_LOOP_S = 180.0
# CK/resnet: bench.py's ckpt leg (bench.py:2987-3094): ResNet-50 with
# fused_loss, Momentum(0.1, 0.9), float32, batch 8, 5 saves of each kind
CK_BATCH, CK_REPS = 8, 5


def build_ctr(service=None):
    """bench.py's ctr_deepfm program -> (main, startup, loss, embeddings);
    `service` replaces the embeddings' in-process service."""
    from paddle_tpu_torch import Program, optimizer, program_guard, unique_name
    from paddle_tpu_torch.models import ctr_deepfm

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 1
    with program_guard(main, startup), unique_name.guard():
        loss, _prob, embs, _svc = ctr_deepfm.build(
            num_fields=CTR_FIELDS, sparse_feature_dim=CTR_IDS,
            embedding_size=CTR_EMB, dense_feature_dim=CTR_DENSE,
            mlp_dims=CTR_MLP, service=service)
        optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss, embs


def ctr_feed(i):
    """bench.py's make_feed(i)."""
    r = np.random.RandomState(i)
    return {"sparse_emb@ids": r.randint(0, CTR_IDS, (CTR_BATCH, CTR_FIELDS)),
            "sparse_w1@ids": r.randint(0, CTR_IDS, (CTR_BATCH, CTR_FIELDS)),
            "dense_x": r.rand(CTR_BATCH, CTR_DENSE).astype("float32"),
            "label": r.randint(0, 2, (CTR_BATCH, 1)).astype("float32")}


def _ctr_loss(out):
    return float(np.asarray(out[0]).reshape(-1)[0])


def _touched_rows(embs, feeds):
    """Each service's rows at every id `feeds` touched (ids already
    resident: reading them changes nothing)."""
    return [e.service.prefetch(np.unique(np.concatenate(
        [f[e.ids_feed_name].reshape(-1) for f in feeds]))) for e in embs]


def _recording(step):
    """Make `step` keep, for each Executor.run, the feed it was given, a
    copy of the scope's persistables before it, and what it returned ->
    (that list of SimpleNamespace(feed, state, out), a function that
    stops the recording)."""
    seen, run = [], step.exe.run

    def recorded(program, feed=None, fetch_list=None, scope=None):
        rec = types.SimpleNamespace(feed=dict(feed),
                                    state=_persistables(scope, program))
        rec.out = run(program, feed=feed, fetch_list=fetch_list,
                      scope=scope)
        seen.append(rec)
        return rec.out

    step.exe = types.SimpleNamespace(run=recorded)

    def stop():
        step.exe = run.__self__
    return seen, stop


def _relu_inputs(program):
    """The pre-activations of the program's ReLUs, in forward order."""
    return [op.inputs["X"][0] for op in program.global_block().ops
            if op.type == "relu"]


def _rerun(exe, main, rec, fetch_list):
    """Run a recorded step again by `exe` in a scratch scope holding a
    copy of the persistables it started from -> the fetches."""
    from paddle_tpu_torch import Scope

    scratch = Scope()
    for name, value in rec.state.items():
        scratch.set_var(name, value.clone())
    return exe.run(main, feed=rec.feed, fetch_list=fetch_list,
                   scope=scratch)


def _kink_witness(device, programs, grad_names, mine, ref, flagged):
    """For each flagged example of one check step (`mine` the card's
    record, `ref` the CPU's; `programs` the card's and the CPU's main
    program), the witness of a ReLU flip: the step is run
    again on both sides (the card by the interpreter, which must give the
    card step's grads bitwise), fetching every ReLU's pre-activation; at
    the first layer where the example's signs differ, the flipped units'
    card-minus-CPU gap must be no larger than that layer's spread over
    the unflagged examples.  -> [record per flagged example]."""
    from paddle_tpu_torch import CPUPlace, Executor

    main, cmain = programs
    fetch = grad_names + _relu_inputs(main)
    card = _rerun(Executor(device, mode="interpret"), main, mine, fetch)
    cpu = _rerun(Executor(CPUPlace()), cmain, ref, fetch)
    n = len(grad_names)
    same_card = all(np.array_equal(a, b) for a, b in zip(card[:n],
                                                        mine.out[1:]))
    same_cpu = all(np.array_equal(a, b) for a, b in zip(cpu[:n],
                                                       ref.out[1:]))
    batch = len(card[n])
    others = np.setdiff1d(np.arange(batch), flagged)
    out = []
    for b in flagged.tolist():
        rec = {"example": b, "reruns_equal_steps": [same_card, same_cpu],
               "layer": None, "within_rounding": False}
        for layer, (a, c) in enumerate(zip(card[n:], cpu[n:])):
            flip = (a[b] > 0) != (c[b] > 0)
            if not flip.any():
                continue
            spread = float(np.abs(a[others] - c[others]).max())
            gap = float(np.abs(a[b][flip] - c[b][flip]).max())
            rec.update(layer=layer, units=int(flip.sum()), gap=gap,
                       spread=spread,
                       card=a[b][flip][:4].tolist(),
                       cpu=c[b][flip][:4].tolist(),
                       within_rounding=bool(same_card and same_cpu
                                            and gap <= spread))
            break
        out.append(rec)
    return out


def _kink_examples(card_grads, cpu_grads):
    """Indices of the examples whose row grads on the card differ from
    the CPU's by more than CTR_KINK of their largest (ReLU kink flips)."""
    g, c = (np.asarray(x).reshape(len(x), -1) for x in (card_grads,
                                                         cpu_grads))
    dev = np.abs(g - c).max(axis=1)
    return np.flatnonzero(dev > CTR_KINK * np.abs(c).max(axis=1))


def _services(embs):
    return {"emb": embs[0].service, "w1": embs[1].service}


def _same_tables(a, b):
    """Two services' shard states are equal bitwise (ids, rows and
    adagrad accumulators)."""
    sa, sb = a.state_dict()["shards"], b.state_dict()["shards"]
    return sorted(sa) == sorted(sb) and all(
        np.array_equal(sa[i][k], sb[i][k])
        for i in sa for k in ("ids", "vals", "accum"))


class _HostSplit:
    """Host seconds a step spends in SparseTrainStep's three parts: the
    prefetch, Executor.run (the device step, its fetches copied to the
    host) and the push, on whichever thread each runs (run_pipelined runs
    the prefetch and the push on its workers)."""

    PARTS = ("prefetch", "exe_run", "push")

    def __init__(self, step):
        self._lock = threading.Lock()
        self._secs = dict.fromkeys(self.PARTS, 0.0)
        step._prefetch = self._timed("prefetch", step._prefetch)
        step._push_grads = self._timed("push", step._push_grads)
        step.exe = types.SimpleNamespace(
            run=self._timed("exe_run", step.exe.run))

    def _timed(self, part, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with self._lock:
                    self._secs[part] += time.perf_counter() - t0
        return timed

    def take(self, steps):
        """ms a step of each part since the last take."""
        with self._lock:
            out = {k: v / steps * 1e3 for k, v in self._secs.items()}
            self._secs = dict.fromkeys(self.PARTS, 0.0)
        return out


def _count_pushes(embs):
    """Count the push_sparse_grad calls that returned, from now on."""
    count, lock = [0], threading.Lock()
    for e in embs:
        def counted(grad, orig=e.service.push_sparse_grad):
            orig(grad)
            with lock:
                count[0] += 1
        e.service.push_sparse_grad = counted
    return count


def phase_ctr(card):
    """CTR: bench.py's ctr_deepfm leg through SparseTrainStep on the jit
    path; -> (record, the startup's persistables on the card)."""
    from paddle_tpu_torch import CPUPlace, Executor, Scope
    from paddle_tpu_torch.framework.executor import _RNG_COUNTER_NAME
    from paddle_tpu_torch.framework.framework import grad_var_name
    from paddle_tpu_torch.sparse.api import SparseTrainStep

    reset_peak_memory()
    before = graph_stats()
    main, startup, loss, embs = build_ctr()
    scope, exe = _seeded_scope(main, startup)
    start = _persistables(scope, main)
    step = SparseTrainStep(exe, main, embs, loss)

    # the port's CPU path from the same persistables, fresh services
    check = [ctr_feed(i) for i in range(CTR_CHECK_STEPS)]
    cmain, _, closs, cembs = build_ctr()
    cscope = Scope()
    for name, value in start.items():
        cscope.set_var(name, value.cpu())
    cstep = SparseTrainStep(Executor(CPUPlace()), cmain, cembs, closs)
    cpu_seen, stop_cpu = _recording(cstep)
    cpu_losses = [_ctr_loss(cstep.run(f, scope=cscope)) for f in check]
    card_seen, stop_card = _recording(step)
    losses = [_ctr_loss(step.run(f, scope=scope)) for f in check]
    stop_card()
    stop_cpu()
    grad_names = [grad_var_name(e.var.name) for e in embs]
    # the flagged examples a step, by service; the rows of the witnessed
    # ones, by service
    kinks = [[] for _ in embs]
    loose = [set() for _ in embs]
    witnesses = []
    for i, (feed, mine, ref) in enumerate(zip(check, card_seen, cpu_seen)):
        bad = [_kink_examples(mine.out[1 + j], ref.out[1 + j])
               for j in range(len(embs))]
        for j in range(len(embs)):
            kinks[j].append(len(bad[j]))
        flagged = np.unique(np.concatenate(bad))
        if not flagged.size:
            continue
        seen = _kink_witness(exe.device, (main, cmain), grad_names, mine,
                             ref, flagged)
        witnesses += [dict(w, step=i) for w in seen]
        shown = [w["example"] for w in seen if w["within_rounding"]]
        for j, e in enumerate(embs):
            ex = np.intersect1d(bad[j], shown)
            loose[j].update(feed[e.ids_feed_name][ex].reshape(-1).tolist())
    row_err = all_rows_err = 0.0
    for e, ce, skip in zip(embs, cembs, loose):
        ids = np.unique(np.concatenate(
            [f[e.ids_feed_name].reshape(-1) for f in check]))
        err = np.abs(e.service.prefetch(ids)
                     - ce.service.prefetch(ids)).max(axis=1)
        all_rows_err = max(all_rows_err, float(err.max()))
        held = ~np.isin(ids, np.fromiter(skip, np.int64, len(skip)))
        row_err = max(row_err, float(err[held].max()))
    if not (np.all(np.isfinite(losses)) and np.allclose(
            losses, cpu_losses, rtol=CTR_RTOL, atol=0)
            and row_err <= CTR_ROW_ATOL
            and all_rows_err <= CTR_KINK_ROW_ATOL
            and max(max(k) for k in kinks) <= CTR_KINK_MAX):
        raise AssertionError(f"CTR: card losses {losses} vs CPU "
                             f"{cpu_losses}, touched rows {row_err}, all "
                             f"{all_rows_err} (flagged examples a step "
                             f"{kinks}, witnesses {witnesses})")
    del cscope, cstep, card_seen, cpu_seen

    # one step by the interpreter (scratch scope) and by the graph, from
    # the same state and rows; the graph's grads are pushed as run() does
    model_feed, ids = step._prefetch(ctr_feed(CTR_CHECK_STEPS))
    scratch = Scope()
    for name, value in _persistables(scope, main).items():
        scratch.set_var(name, value)
    scratch.set_var(_RNG_COUNTER_NAME, scope.find_var(_RNG_COUNTER_NAME))
    ref = Executor(exe.device, mode="interpret").run(
        main, feed=model_feed, fetch_list=[loss] + grad_names, scope=scratch)
    del scratch
    got = exe.run(main, feed=model_feed, fetch_list=[loss] + grad_names,
                  scope=scope)
    step._push_grads(ids, got[1:])
    jit_err = [float(np.abs(a - b).max()) for a, b in zip(got, ref)]
    if not (np.allclose(got[0], ref[0], rtol=JIT_RTOL, atol=0)
            and all(e <= JIT_RTOL * float(np.abs(r).max())
                    for e, r in zip(jit_err[1:], ref[1:]))):
        raise AssertionError(f"CTR: jit vs interpret max abs {jit_err}")

    split = _HostSplit(step)
    split.take(1)
    feeds = [ctr_feed(10 + i) for i in range(CTR_STEPS)]
    cuda_sync()
    t0 = time.perf_counter()
    sync = [_ctr_loss(step.run(f, scope=scope)) for f in feeds]
    sync_s = time.perf_counter() - t0
    sync_split = split.take(CTR_STEPS)

    pushes = _count_pushes(embs)
    feeds = [ctr_feed(30 + i) for i in range(CTR_STEPS)]
    cuda_sync()
    t0 = time.perf_counter()
    piped = [_ctr_loss(out)
             for out in step.run_pipelined(iter(feeds), scope=scope)]
    pipe_s = time.perf_counter() - t0
    pipe_split = split.take(CTR_STEPS)
    barrier_pushes = pushes[0]
    if barrier_pushes != len(embs) * CTR_STEPS:
        raise AssertionError(f"CTR: {barrier_pushes} pushes applied after "
                             f"the pipelined barrier, not "
                             f"{len(embs) * CTR_STEPS}")
    if not np.all(np.isfinite(sync + piped)):
        raise AssertionError(f"CTR: losses {sync} {piped}")

    profiled = iter([ctr_feed(50 + i) for i in range(CTR_PROFILED)])
    prof = profile_calls(lambda: step.run(next(profiled), scope=scope),
                         CTR_PROFILED)
    graphs, bound = captured_graphs("CTR", exe, model_feed)
    if graphs != 1:
        raise AssertionError(f"CTR: {graphs} graphs captured, not 1")
    res = {"phase": "CTR", "batch": CTR_BATCH, "fields": CTR_FIELDS,
           "ids": CTR_IDS, "mlp": list(CTR_MLP), "steps": CTR_STEPS,
           "sync_examples_per_s": CTR_BATCH * CTR_STEPS / sync_s,
           "pipelined_examples_per_s": CTR_BATCH * CTR_STEPS / pipe_s,
           "sync_ms_per_step": sync_s / CTR_STEPS * 1e3,
           "pipelined_ms_per_step": pipe_s / CTR_STEPS * 1e3,
           "host_split_ms_sync": sync_split,
           "host_split_ms_pipelined": pipe_split,
           "losses_check": losses, "losses_cpu": cpu_losses,
           "touched_rows_max_abs_err": row_err,
           "kink_examples_a_step": kinks,
           "kink_witnesses": witnesses,
           "rows_of_kink_examples": [len(x) for x in loose],
           "all_touched_rows_max_abs_err": all_rows_err,
           "jit_vs_interpret_max_abs": jit_err,
           "losses_sync": [sync[0], sync[-1]],
           "losses_pipelined": [piped[0], piped[-1]],
           "pushes_after_barrier": barrier_pushes,
           "graphs": graphs, "bound_args": bound,
           "rows_resident": [sum(len(s._ids) for s in e.service.shards)
                             for e in embs],
           "profile": prof, "card": card}
    res.update(capture_fields(before, prof, res["sync_ms_per_step"]))
    log(f"    CTR: sync {res['sync_examples_per_s']:.0f} examples/s "
        f"({res['sync_ms_per_step']:.2f} ms/step: prefetch "
        f"{sync_split['prefetch']:.2f}, exe.run {sync_split['exe_run']:.2f},"
        f" push {sync_split['push']:.2f}), pipelined "
        f"{res['pipelined_examples_per_s']:.0f} examples/s "
        f"({res['pipelined_ms_per_step']:.2f} ms/step: prefetch "
        f"{pipe_split['prefetch']:.2f}, exe.run {pipe_split['exe_run']:.2f},"
        f" push {pipe_split['push']:.2f} on their threads); card vs CPU "
        f"losses {losses} vs {cpu_losses}, rows {row_err:.3g} (kink "
        f"examples a step {kinks}, their rows {all_rows_err:.3g}; "
        f"witnesses {witnesses}); jit vs "
        f"interpret {jit_err}; {barrier_pushes} pushes after the barrier "
        f"[{card}]")
    log_capture("CTR", res)
    return res, start


def phase_ctr_resume(card, start):
    """CTR/resume: RESUME_STEPS sync steps with a checkpoint (dense state
    and both services) after step RESUME_AT, then the later steps again
    from it in a fresh scope with fresh services: losses and tables
    bitwise the uninterrupted run's."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.sparse.api import SparseTrainStep

    root = _saved_dir("sparse_resume")
    feeds = [ctr_feed(100 + i) for i in range(RESUME_STEPS)]
    main, startup, loss, embs = build_ctr()
    scope, exe = _seeded_scope(main, startup, start)
    step = SparseTrainStep(exe, main, embs, loss)
    mgr = CheckpointManager(root)
    losses = []
    for i, feed in enumerate(feeds):
        losses.append(_ctr_loss(step.run(feed, scope=scope)))
        if i + 1 == RESUME_AT:
            t0 = time.perf_counter()
            mgr.save(RESUME_AT, scope=scope, main_program=main,
                     services=_services(embs))
            submit_s = time.perf_counter() - t0
    mgr.wait()
    rmain, rstartup, rloss, rembs = build_ctr()
    rscope, rexe = _seeded_scope(rmain, rstartup)
    t0 = time.perf_counter()
    state = mgr.restore(scope=rscope, main_program=rmain,
                        services=_services(rembs))
    restore_s = time.perf_counter() - t0
    rstep = SparseTrainStep(rexe, rmain, rembs, rloss)
    resumed = [_ctr_loss(rstep.run(f, scope=rscope))
               for f in feeds[RESUME_AT:]]
    tables = [_same_tables(a.service, b.service)
              for a, b in zip(embs, rembs)]
    if resumed != losses[RESUME_AT:] or not all(tables) or \
            state["step"] != RESUME_AT:
        raise AssertionError(f"CTR/resume: resumed losses {resumed} vs "
                             f"{losses[RESUME_AT:]}, tables equal {tables}")
    shutil.rmtree(root, ignore_errors=True)
    res = {"phase": "CTR/resume", "losses": losses, "resumed": resumed,
           "tables_equal": tables, "save_submit_ms": submit_s * 1e3,
           "restore_ms": restore_s * 1e3,
           "restored_vars": len(state["restored_vars"]), "card": card}
    log(f"    CTR/resume: steps {RESUME_AT + 1}-{RESUME_STEPS} after the "
        f"restore equal the uninterrupted run's bitwise ({resumed}), both "
        f"tables equal; save submit {res['save_submit_ms']:.1f} ms, restore "
        f"{res['restore_ms']:.1f} ms ({res['restored_vars']} vars) [{card}]")
    return res


def _start_shard_server(index, num_shards, dim, tmp, tag, optimizer,
                        learning_rate):
    """Start `python -m paddle_tpu_torch.sparse.server`; -> (process,
    ready file, start time)."""
    ready = os.path.join(tmp, f"ep{index}{tag}.{time.time_ns()}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.sparse.server",
         "--shard-index", str(index), "--num-shards", str(num_shards),
         "--dim", str(dim), "--port", "0", "--ready-file", ready,
         "--optimizer", optimizer, "--learning-rate", str(learning_rate)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return proc, ready, time.perf_counter()


def _shard_endpoint(proc, ready, timeout=60.0):
    """Wait for a started server's ready file -> its endpoint."""
    deadline = time.time() + timeout
    while not os.path.exists(ready):
        if proc.poll() is not None or time.time() > deadline:
            proc.kill()
            raise RuntimeError(f"shard server {ready} failed to start")
        time.sleep(0.02)
    with open(ready) as f:
        return f.read().strip()


def _card_processes():
    """(the compute processes nvidia-smi lists, the card's used MiB)."""
    return len(_compute_apps_mib()), _card_used_mib()


def _servers_off_the_card(before, label, pids, mib=True):
    """Check that the live shard servers `pids` hold no CUDA context: with
    them running, nvidia-smi lists no more compute processes than
    `before` (a _card_processes() taken before they started, while this
    process held its own context) and, with `mib`, the card's used memory
    grew by less than SERVER_CARD_MIB (a context takes hundreds)."""
    apps, used = _card_processes()
    grew = used - before[1]
    if before[0] < 1 or apps != before[0] or (mib and grew >= SERVER_CARD_MIB):
        raise AssertionError(
            f"{label}: {len(pids)} shard servers alive, nvidia-smi lists "
            f"{apps} compute processes ({before[0]} before), the card's "
            f"used memory grew {grew} MiB")
    return {"servers": len(pids), "compute_processes": apps,
            "card_mib_grown": grew if mib else None}


def phase_ctr_remote(card, start):
    """CTR/remote: the model's embeddings over 2 shard-server processes
    under a ShardSupervisor (bench.py's recovery protocol), kill -9 of
    shard 1 mid-run: the loop sees no exception, and losses and tables
    equal an uninterrupted in-process run's on the card bitwise."""
    from paddle_tpu_torch.resilience import RpcPolicy, ShardSupervisor
    from paddle_tpu_torch.sparse import RemoteEmbeddingService
    from paddle_tpu_torch.sparse.api import SparseTrainStep

    tmp = _saved_dir("sparse_remote")
    procs, all_procs, start_s = {}, [], []

    def spawn(index, tag):
        proc, ready, t0 = _start_shard_server(index, 2, CTR_EMB, tmp, tag,
                                              "adagrad", 0.01)
        procs[index] = proc
        all_procs.append(proc)
        ep = _shard_endpoint(proc, ready)
        start_s.append(time.perf_counter() - t0)
        return ep

    sup = svc = None
    cuda_sync()
    before = _card_processes()
    try:
        started = [_start_shard_server(i, 2, CTR_EMB, tmp, "", "adagrad",
                                       0.01) for i in range(2)]
        endpoints = []
        for i, (proc, ready, t0) in enumerate(started):
            procs[i] = proc
            all_procs.append(proc)
            endpoints.append(_shard_endpoint(proc, ready))
            start_s.append(time.perf_counter() - t0)
        smi = [_servers_off_the_card(before, "CTR/remote", endpoints)]
        svc = RemoteEmbeddingService(
            endpoints, CTR_IDS, CTR_EMB,
            policy=RpcPolicy(connect_timeout=1.0, call_timeout=2.0,
                             max_attempts=2, backoff_base=0.05))
        sup = ShardSupervisor(
            svc, checkpoint_root=os.path.join(tmp, "ckpts"),
            spawn=lambda i: spawn(i, ".r"), ping_interval=0.1,
            recovery_timeout=60.0).start()
        main, startup, loss, embs = build_ctr(service=svc)
        scope, exe = _seeded_scope(main, startup, start)
        step = SparseTrainStep(exe, main, embs, loss)
        feeds = [ctr_feed(200 + i) for i in range(REMOTE_STEPS)]
        losses, step_ms = [], []
        for i, feed in enumerate(feeds):
            if i == REMOTE_CKPT_AT:
                sup.checkpoint()
            if i == REMOTE_KILL_AT:
                t_kill = time.perf_counter()
                os.kill(procs[1].pid, signal.SIGKILL)
                procs[1].wait()
            t0 = time.perf_counter()
            losses.append(_ctr_loss(step.run(feed, scope=scope)))
            t1 = time.perf_counter()
            step_ms.append((t1 - t0) * 1e3)
            if i == REMOTE_KILL_AT:
                mttr_step = t1 - t_kill
        kinds = [k for _, k, _i, _d in sup.events]
        for kind in ("shard_down", "shard_respawned", "checkpoint_restored",
                     "journal_replayed", "shard_recovered"):
            if kind not in kinds:
                raise AssertionError(f"CTR/remote: no {kind} in {kinds}")
        mttr_sup = next(float(d[5:-1]) for _, k, _i, d in sup.events
                        if k == "shard_recovered" and d.startswith("mttr="))
        smi.append(_servers_off_the_card(
            before, "CTR/remote after the respawn",
            [p.pid for p in procs.values() if p.poll() is None], mib=False))

        # the uninterrupted run: in-process services, same card and start
        imain, istartup, iloss, iembs = build_ctr()
        iscope, iexe = _seeded_scope(imain, istartup, start)
        istep = SparseTrainStep(iexe, imain, iembs, iloss)
        want = [_ctr_loss(istep.run(f, scope=iscope)) for f in feeds]
        rows = [np.array_equal(a, b) for a, b in zip(
            _touched_rows(embs, feeds), _touched_rows(iembs, feeds))]
        if losses != want or not all(rows):
            raise AssertionError(f"CTR/remote: losses {losses} vs "
                                 f"uninterrupted {want}, tables equal {rows}")
    finally:
        if sup is not None:
            sup.stop()
        if svc is not None:
            svc.close()
        for proc in all_procs:
            proc.kill()
            proc.wait()
    shutil.rmtree(tmp, ignore_errors=True)
    healthy = statistics.median(step_ms[:REMOTE_KILL_AT]
                                + step_ms[REMOTE_KILL_AT + 1:])
    res = {"phase": "CTR/remote", "steps": REMOTE_STEPS, "losses": losses,
           "tables_equal": rows, "mttr_step_s": mttr_step,
           "mttr_supervisor_s": mttr_sup, "healthy_step_ms": healthy,
           "server_start_s": start_s, "servers_off_the_card": smi,
           "card": card}
    log(f"    CTR/remote: kill -9 of shard 1 before step "
        f"{REMOTE_KILL_AT + 1}: step-observed MTTR {mttr_step:.3f} s, "
        f"supervisor {mttr_sup:.3f} s, healthy step {healthy:.1f} ms; "
        f"server start {[round(s, 2) for s in start_s]} s; losses and "
        f"tables equal the uninterrupted run's bitwise; servers off the "
        f"card: {smi} [{card}]")
    return res


def phase_reshard(card):
    """SP/reshard: bench.py's reshard leg (bench.py:2837-2986) on the
    port's shard servers: prefetch/push examples/s at 1, 2, 4 and 8
    servers, then a live 2 -> 4 reshard under load (the worst step stall
    while it runs), the table after it bitwise its in-process mirror's."""
    from paddle_tpu_torch.resilience import RpcPolicy, ShardSupervisor
    from paddle_tpu_torch.sparse import (EmbeddingService,
                                         RemoteEmbeddingService, SelectedRows)

    tmp = _saved_dir("sparse_reshard")
    all_procs = []

    def spawn_all(n, tag, indices):
        started = [_start_shard_server(i, n, RS_DIM, tmp, tag, "sgd", 0.05)
                   for i in indices]
        all_procs.extend(p for p, _, _ in started)
        return [_shard_endpoint(p, ready) for p, ready, _ in started]

    def one_step(svc, rng):
        ids = rng.randint(0, CTR_IDS, RS_BATCH * RS_FIELDS).astype(np.int64)
        grads = rng.uniform(-1, 1, (len(ids), RS_DIM)).astype(np.float32)
        svc.prefetch(ids)
        svc.push_sparse_grad(SelectedRows(ids, grads, CTR_IDS))
        return ids, grads

    policy = RpcPolicy(connect_timeout=1.0, call_timeout=5.0,
                       max_attempts=2, backoff_base=0.05)
    sup = svc = None
    cuda_sync()
    before = _card_processes()
    try:
        sweep = {}
        for n in RS_SHARDS:
            svc = RemoteEmbeddingService(spawn_all(n, f".t{n}", range(n)),
                                         CTR_IDS, RS_DIM, policy=policy)
            if n == max(RS_SHARDS):
                smi = _servers_off_the_card(before, "SP/reshard",
                                            svc.shards)
            rng = np.random.RandomState(n)
            for _ in range(2):
                one_step(svc, rng)
            t0 = time.perf_counter()
            for _ in range(RS_STEPS):
                one_step(svc, rng)
            sweep[n] = RS_BATCH * RS_STEPS / (time.perf_counter() - t0)
            svc.close(shutdown_servers=True)
            svc = None

        svc = RemoteEmbeddingService(spawn_all(2, ".m", range(2)), CTR_IDS,
                                     RS_DIM, policy=policy)
        mirror = EmbeddingService(CTR_IDS, RS_DIM, num_shards=1,
                                  optimizer="sgd", learning_rate=0.05)
        sup = ShardSupervisor(
            svc, checkpoint_root=os.path.join(tmp, "ckpts"),
            spawn=lambda i: spawn_all(4, ".m", [i])[0], ping_interval=0.2,
            recovery_timeout=60.0).start()
        done = {}

        def drive():
            t0 = time.perf_counter()
            sup.reshard(4)
            done["reshard_s"] = time.perf_counter() - t0

        rng = np.random.RandomState(99)
        windows, touched = [], []
        thr = t_rs0 = t_rs1 = None
        tail_after = 0
        t_loop = time.perf_counter()
        while time.perf_counter() - t_loop < RS_LOOP_S:
            if len(windows) == 5:
                t_rs0 = time.perf_counter()
                thr = threading.Thread(target=drive, daemon=True)
                thr.start()
            t0 = time.perf_counter()
            ids, grads = one_step(svc, rng)
            windows.append((t0, time.perf_counter()))
            mirror.push_sparse_grad(SelectedRows(ids, grads, CTR_IDS))
            touched.append(ids)
            if thr is not None and not thr.is_alive():
                t_rs1 = t_rs1 or time.perf_counter()
                tail_after += 1
                if tail_after >= 5:
                    break
        thr.join(timeout=120.0)
        if "reshard_s" not in done or t_rs1 is None:
            raise AssertionError("SP/reshard: the live reshard did not end "
                                 "while the loop stepped")
        during = [b - a for a, b in windows
                  if b >= t_rs0 and (t_rs1 is None or a <= t_rs1)]
        healthy = statistics.median(
            [b - a for a, b in windows
             if b < t_rs0 or (t_rs1 is not None and a > t_rs1)])
        audit = np.unique(np.concatenate(touched))
        exact = np.array_equal(svc.prefetch(audit), mirror.prefetch(audit))
        if not exact or svc.num_shards != 4:
            raise AssertionError(f"SP/reshard: {svc.num_shards} shards, "
                                 f"table equal to its mirror: {exact}")
        epoch = svc.routing.epoch
    finally:
        if sup is not None:
            sup.stop()
        if svc is not None:
            svc.close()
        for proc in all_procs:
            proc.kill()
            proc.wait()
    shutil.rmtree(tmp, ignore_errors=True)
    res = {"phase": "SP/reshard", "batch": RS_BATCH, "fields": RS_FIELDS,
           "dim": RS_DIM, "steps": RS_STEPS,
           "examples_per_s_by_shards": {str(k): v for k, v in sweep.items()},
           "reshard_s": done["reshard_s"], "worst_stall_s": max(during),
           "healthy_step_s": healthy, "steps_during_reshard": len(during),
           "routing_epoch": epoch, "audited_ids": len(audit),
           "table_equal_mirror": exact, "servers_off_the_card": smi,
           "card": card}
    log(f"    SP/reshard: examples/s by shards "
        f"{ {k: round(v) for k, v in sweep.items()} }; live 2 -> 4 in "
        f"{done['reshard_s']:.2f} s, worst stall {max(during):.3f} s over "
        f"{len(during)} steps (healthy {healthy * 1e3:.1f} ms), epoch "
        f"{epoch}; {len(audit)} ids equal the mirror bitwise [{card}]")
    return res


def phase_ckpt(card):
    """CK/resnet: bench.py's ckpt leg: sync and async saves of ResNet-50's
    state through CheckpointManager, a restore into a fresh scope, and the
    loss through the pruned forward equal before and after."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope
    from paddle_tpu_torch.checkpoint import CheckpointManager

    main, startup, loss, _ = build_resnet(use_amp=False, lr=0.1)
    feed = _resnet_feed(CK_BATCH, 0)
    eval_prog = main._prune([loss.name])
    root = _saved_dir("ckpt_resnet")
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    (before,) = exe.run(eval_prog, feed=feed, fetch_list=[loss], scope=scope)
    sync_mgr = CheckpointManager(os.path.join(root, "sync"), keep_last_k=2,
                                 async_save=False)
    sync_s = []
    for i in range(CK_REPS):
        t0 = time.perf_counter()
        path = sync_mgr.save(i + 1, scope=scope, main_program=main)
        sync_s.append(time.perf_counter() - t0)
    state_bytes = sum(os.path.getsize(os.path.join(base, f))
                      for base, _d, files in os.walk(path) for f in files)
    async_mgr = CheckpointManager(os.path.join(root, "async"),
                                  keep_last_k=2, async_save=True)
    submit_s, total_s = [], []
    for i in range(CK_REPS):
        t0 = time.perf_counter()
        async_mgr.save(i + 1, scope=scope, main_program=main)
        submit_s.append(time.perf_counter() - t0)
        async_mgr.wait()
        total_s.append(time.perf_counter() - t0)
    scope2, exe2 = Scope(), Executor(CUDAPlace(0))
    exe2.run(startup, scope=scope2)
    t0 = time.perf_counter()
    state = sync_mgr.restore(scope=scope2, main_program=main)
    restore_s = time.perf_counter() - t0
    (after,) = exe2.run(eval_prog, feed=feed, fetch_list=[loss],
                        scope=scope2)
    before, after = float(before.reshape(-1)[0]), float(after.reshape(-1)[0])
    if after != before:
        raise AssertionError(f"CK/resnet: loss {after} after the restore, "
                             f"{before} before")
    shutil.rmtree(root, ignore_errors=True)
    res = {"phase": "CK/resnet", "batch": CK_BATCH, "reps": CK_REPS,
           "sync_save_ms": min(sync_s) * 1e3,
           "async_submit_ms": min(submit_s) * 1e3,
           "async_total_ms": min(total_s) * 1e3,
           "restore_ms": restore_s * 1e3, "state_bytes": state_bytes,
           "n_vars": len(state["restored_vars"]),
           "loss_before": before, "loss_after": after, "card": card}
    log(f"    CK/resnet: sync save {res['sync_save_ms']:.1f} ms, async "
        f"submit {res['async_submit_ms']:.1f} ms (total "
        f"{res['async_total_ms']:.1f}), restore {res['restore_ms']:.1f} ms; "
        f"{state_bytes} bytes in {res['n_vars']} vars; loss {before} before "
        f"and after [{card}]")
    return res


def drive_sparse(card, lap=lambda phase: None):
    """[16]: CTR, CTR/resume, CTR/remote, SP/reshard, CK/resnet; none of
    the eight kernels launches."""
    _zero_counts()
    results = []
    res, start = phase_ctr(card)
    results.append(res)
    lap("[16] CTR")
    results.append(phase_ctr_resume(card, start))
    lap("[16] CTR/resume")
    results.append(phase_ctr_remote(card, start))
    lap("[16] CTR/remote")
    del start
    torch.cuda.empty_cache()
    results.append(phase_reshard(card))
    lap("[16] SP/reshard")
    results.append(phase_ckpt(card))
    lap("[16] CK/resnet")
    launched = {k: n for k, n in _port_kernel_counts().items() if n}
    if launched:
        raise AssertionError(f"[16] launched port kernels: {launched}")
    return results


# ------------------------------------------------- [17] the dense op tails

# X/ops: every op type of the dense tails, grouped; the image ops at a
# ResNet stage's shape, the 3-D ops on 16^3 volumes, the tensor and loss
# ops at [256, 1024]
X_IMG = (32, 64, 56, 56)
X_VOL = (4, 16, 16, 16, 16)
X_ROWS = (256, 1024)
X_TOL = 1e-4        # card vs CPU: max abs error / max(1, the largest |CPU|)
# the random group's draws: moments within about 5 standard errors
XR_ROWS = (256, 1024)
X_REPS = 10         # timed replays of a group's captured segment
# X/attn: the primitive-level encoder at transformer-base width
XA_PARITY_BATCH, XA_PARITY_STEPS = 8, 3
XA_BATCH, XA_WARMUP, XA_STEPS, XA_PROFILED = 64, 2, 10, 2
XA_LR = 1e-4
XA_RTOL = 1e-4      # card vs CPU losses
# X/metrics
XM_AUC_BATCH, XM_AUC_BATCHES, XM_AUC_THRESHOLDS = 4096, 20, 4095
XM_CHUNK_SHAPE, XM_CHUNK_BATCHES = (64, 128), 10
XM_PR_BATCH, XM_PR_BATCHES = 4096, 10
XM_AUC_TOL = 1e-6


def _xo(rng, *shape, lo=None, hi=None):
    if lo is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _x_groups(rng):
    """{group: [(op type, inputs, attrs, differentiable inputs, outputs
    {param: count}, outputs the loss reads)]} at the card shapes; the
    pools' windows do not overlap (an overlapped max or 3-D average pool
    backward adds with atomics, whose order a replay need not keep)."""
    r, c = X_ROWS
    x = _xo(rng, r, c)
    y = _xo(rng, r, c)
    img = _xo(rng, *X_IMG)
    vol = _xo(rng, *X_VOL)
    n, ch, h, w = X_IMG
    vc = X_VOL[1]
    ids = rng.permutation(r)[: r // 4].astype(np.int64)
    lab01 = rng.randint(0, 2, (r, 1)).astype(np.float32)
    prob = _xo(rng, r, 1, lo=0.02, hi=0.98)
    target = np.where(rng.rand(r, c) < 0.3, 0.0, rng.rand(r, c)).astype(
        np.float32)
    tags = rng.randint(0, 9, (64, 128)).astype(np.int64)
    out1 = {"Out": 1}
    tensor = [
        ("reshape2", {"X": [x]}, {"shape": [r * 4, -1]}, ["X"],
         {"Out": 1, "XShape": 1}, ["Out"]),
        ("transpose", {"X": [x]}, {"axis": [1, 0]}, ["X"], out1, ["Out"]),
        ("transpose2", {"X": [x.reshape(r, c // 32, 32)]},
         {"axis": [2, 0, 1]},
         ["X"], {"Out": 1, "XShape": 1}, ["Out"]),
        ("split", {"X": [x]}, {"axis": 1, "num": 0,
                               "sections": [c // 4, c // 2, c // 4]}, ["X"],
         {"Out": 3}, ["Out"]),
        ("squeeze2", {"X": [x.reshape(r, 1, c)]}, {"axes": [1]}, ["X"],
         {"Out": 1, "XShape": 1}, ["Out"]),
        ("unsqueeze2", {"X": [x]}, {"axes": [1]}, ["X"],
         {"Out": 1, "XShape": 1}, ["Out"]),
        ("squeeze", {"X": [y.reshape(r, c, 1)]}, {"axes": []}, ["X"], out1,
         ["Out"]),
        ("unsqueeze", {"X": [y]}, {"axes": [0, 3]}, ["X"], out1, ["Out"]),
        ("stack", {"X": [x, y]}, {"axis": 1}, ["X"], {"Y": 1}, ["Y"]),
        ("unstack", {"X": [x[:4]]}, {"axis": 0}, ["X"], {"Y": 4}, ["Y"]),
        ("expand", {"X": [x[:, :c // 4]]}, {"expand_times": [2, 4]}, ["X"],
         out1, ["Out"]),
        ("pad", {"X": [x]}, {"paddings": [1, 2, 3, 0], "pad_value": 0.5},
         ["X"], out1, ["Out"]),
        ("pad2d", {"X": [img]}, {"paddings": [1, 2, 3, 1],
                                 "mode": "reflect"}, ["X"], out1, ["Out"]),
        ("scatter", {"X": [x], "Ids": [ids], "Updates": [y[: r // 4]]}, {},
         ["X", "Updates"], out1, ["Out"]),
        ("arg_max", {"X": [x]}, {"axis": 1}, [], out1, []),
        ("arg_min", {"X": [x]}, {"axis": 0}, [], out1, []),
        ("argsort", {"X": [x]}, {"axis": -1}, [],
         {"Out": 1, "Indices": 1}, []),
        ("shape", {"Input": [img]}, {}, [], out1, []),
        ("fill", {}, {"shape": [2, 3], "dtype": "float32",
                      "value": [0.5, -1.0, 2.0, 3.0, 4.0, 5.5]}, [], out1,
         []),
        ("fill_zeros_like", {"X": [x]}, {}, ["X"], out1, ["Out"]),
        ("select", {"Condition": [rng.randint(0, 2, (r,)).astype(np.int32)],
                    "X": [x], "Y": [y]}, {}, ["X", "Y"], out1, ["Out"]),
        ("diag", {"Diagonal": [x[0]]}, {}, [], out1, []),
        ("reverse", {"X": [x]}, {"axis": [0, 1]}, ["X"], out1, ["Out"]),
    ]
    math_ops = [
        ("elementwise_floordiv", {"X": [x * 8.0], "Y": [np.abs(y) + 0.5]},
         {"axis": -1}, ["X", "Y"], out1, ["Out"]),
        ("elementwise_floordiv",
         {"X": [rng.randint(-99, 99, (r, c)).astype(np.int32)],
          "Y": [rng.randint(1, 9, (c,)).astype(np.int32)]}, {"axis": -1}, [],
         out1, []),
        ("cumsum", {"X": [x]}, {"axis": 1}, ["X"], out1, ["Out"]),
        ("cumsum", {"X": [y]}, {"axis": 0, "exclusive": True,
                                "reverse": True}, ["X"], out1, ["Out"]),
        ("pow", {"X": [np.abs(x) + 0.1]}, {"factor": 2.5}, ["X"], out1,
         ["Out"]),
        ("isfinite", {"X": [x]}, {}, [], out1, []),
        ("isinf", {"X": [x]}, {}, [], out1, []),
        ("isnan", {"X": [np.where(rng.rand(r, c) < 1e-4, np.nan, x).astype(
            np.float32)]}, {}, [], out1, []),
    ]
    loss = [
        ("smooth_l1_loss", {"X": [x], "Y": [y], "InsideWeight": [
            _xo(rng, r, c, lo=0.0, hi=1.0)]}, {"sigma": 1.5}, ["X", "Y"],
         {"Diff": 1, "Out": 1}, ["Out"]),
        ("huber_loss", {"X": [x], "Y": [y]}, {"delta": 0.7}, ["X", "Y"],
         {"Residual": 1, "Out": 1}, ["Out"]),
        ("log_loss", {"Predicted": [prob], "Labels": [lab01]},
         {"epsilon": 1e-4}, ["Predicted"], {"Loss": 1}, ["Loss"]),
        ("hinge_loss", {"Logits": [x[:, :1]], "Labels": [lab01]}, {},
         ["Logits"], {"Loss": 1}, ["Loss"]),
        ("rank_loss", {"Label": [lab01], "Left": [x[:, :1]],
                       "Right": [y[:, :1]]}, {}, ["Left", "Right"], out1,
         ["Out"]),
        ("margin_rank_loss", {"Label": [2.0 * lab01 - 1.0], "X1": [x[:, :1]],
                              "X2": [y[:, :1]]}, {"margin": 0.1},
         ["X1", "X2"], {"Activated": 1, "Out": 1}, ["Out"]),
        ("mse_loss", {"X": [x], "Y": [y]}, {}, ["X", "Y"], out1, ["Out"]),
        ("kldiv_loss", {"X": [x], "Target": [target]},
         {"reduction": "batchmean"}, ["X"], {"Loss": 1}, ["Loss"]),
        ("auc", {"Predict": [np.concatenate([1.0 - prob, prob], 1)],
                 "Label": [lab01.astype(np.int64)],
                 "StatPos": [np.zeros(4096, np.int64)],
                 "StatNeg": [np.zeros(4096, np.int64)]},
         {"num_thresholds": 4095}, [],
         {"AUC": 1, "StatPosOut": 1, "StatNegOut": 1}, []),
        ("chunk_eval", {"Inference": [tags], "Label": [
            rng.randint(0, 9, (64, 128)).astype(np.int64)],
                        "SeqLen": [rng.randint(1, 129, (64,)).astype(
                            np.int64)]},
         {"chunk_scheme": "IOBES", "num_chunk_types": 2}, [],
         {"Precision": 1, "Recall": 1, "F1-Score": 1, "NumInferChunks": 1,
          "NumLabelChunks": 1, "NumCorrectChunks": 1}, []),
        ("precision_recall", {"Indices": [rng.randint(0, 10, (r, 1))],
                              "Labels": [rng.randint(0, 10, (r, 1))],
                              "Weights": [_xo(rng, r, 1, lo=0.0, hi=1.0)]},
         {"class_number": 10}, [], {"BatchMetrics": 1, "AccumMetrics": 1,
                                    "AccumStatesInfo": 1}, []),
        ("positive_negative_pair", {"Score": [x[:, :3]], "Label": [
            rng.randint(0, 3, (r, 1)).astype(np.float32)],
                                    "QueryID": [rng.randint(0, 16, (r, 1))]},
         {"column": -1}, [], {"PositivePair": 1, "NegativePair": 1,
                              "NeutralPair": 1}, []),
    ]
    misc = [
        ("flatten", {"X": [img]}, {"axis": 2}, ["X"], out1, ["Out"]),
        ("flatten2", {"X": [img]}, {"axis": 1}, ["X"],
         {"Out": 1, "XShape": 1}, ["Out"]),
        ("crop", {"X": [img], "Offsets": [np.array([1, 3, 5, 7], np.int32)]},
         {"shape": [n // 2, ch // 2, h - 8, w - 16]}, ["X"], out1, ["Out"]),
        ("multiplex", {"Ids": [rng.randint(0, 2, (r, 1)).astype(np.int32)],
                       "X": [x, y]}, {}, ["X"], out1, ["Out"]),
        ("pad_constant_like", {"X": [x], "Y": [y[:r - r // 8, :c - c // 8]]},
         {"pad_value": 0.25}, ["Y"], out1, ["Out"]),
        ("is_empty", {"X": [x]}, {}, [], out1, []),
        ("minus", {"X": [x], "Y": [y]}, {}, ["X", "Y"], out1, ["Out"]),
        ("l1_norm", {"X": [x]}, {}, ["X"], out1, ["Out"]),
        ("squared_l2_distance", {"X": [x], "Y": [y[:1]]}, {}, ["X", "Y"],
         {"sub_result": 1, "Out": 1}, ["Out"]),
        ("modified_huber_loss", {"X": [x[:, :1]], "Y": [lab01]}, {}, ["X"],
         {"IntermediateVal": 1, "Out": 1}, ["Out"]),
        ("mean_iou", {"Predictions": [rng.randint(0, 21, (r * 16,))],
                      "Labels": [rng.randint(0, 21, (r * 16,))]},
         {"num_classes": 21}, [], {"OutMeanIou": 1, "OutWrong": 1,
                                   "OutCorrect": 1}, []),
        ("affine_channel", {"X": [img], "Scale": [_xo(rng, ch)],
                            "Bias": [_xo(rng, ch)]}, {},
         ["X", "Scale", "Bias"], out1, ["Out"]),
        ("bilinear_tensor_product", {"X": [x[:, :64]], "Y": [y[:, :32]],
                                     "Weight": [_xo(rng, 16, 64, 32)],
                                     "Bias": [_xo(rng, 1, 16)]}, {},
         ["X", "Y", "Weight", "Bias"], out1, ["Out"]),
        ("row_conv", {"X": [x.reshape(16, r // 16, c)],
                      "Filter": [_xo(rng, 4, c)],
                      "SeqLen": [rng.randint(1, r // 16 + 1, (16,)).astype(
                          np.int64)]},
         {}, ["X", "Filter"], out1, ["Out"]),
        ("ctc_align", {"Input": [rng.randint(0, 5, (r, 64)).astype(
            np.int64)]}, {"blank": 0, "merge_repeated": True}, [],
         {"Output": 1, "OutLength": 1}, []),
        ("conv_shift", {"X": [x], "Y": [y[:, :5]]}, {}, ["X", "Y"], out1,
         ["Out"]),
        ("polygon_box_transform", {"Input": [img[:, :8]]}, {}, [],
         {"Output": 1}, []),
        ("fused_elemwise_activation", {"X": [x], "Y": [y]},
         {"functor_list": ["relu", "elementwise_add"]}, ["X", "Y"],
         {"Out": 1, "IntermediateOut": 1}, ["Out"]),
    ]
    nn = [
        ("conv2d_transpose", {"Input": [img], "Filter": [
            _xo(rng, ch, ch, 4, 4) * 0.05]},
         {"strides": [2, 2], "paddings": [1, 1], "groups": 1}, ["Input",
                                                               "Filter"],
         {"Output": 1}, ["Output"]),
        ("depthwise_conv2d_transpose", {"Input": [img], "Filter": [
            _xo(rng, ch, 1, 3, 3)]}, {"strides": [1, 1], "paddings": [1, 1],
                                      "groups": ch}, ["Input", "Filter"],
         {"Output": 1}, ["Output"]),
        ("group_norm", {"X": [img], "Scale": [_xo(rng, ch)],
                        "Bias": [_xo(rng, ch)]}, {"groups": ch // 2,
                                                  "epsilon": 1e-5},
         ["X", "Scale", "Bias"], {"Y": 1, "Mean": 1, "Variance": 1}, ["Y"]),
        ("bilinear_interp", {"X": [img]}, {"out_h": 2 * h, "out_w": 2 * w},
         ["X"], out1, ["Out"]),
        ("bilinear_interp", {"X": [img]}, {"out_h": h // 2, "out_w": w // 2},
         ["X"], out1, ["Out"]),
        ("nearest_interp", {"X": [img]}, {"out_h": 2 * h, "out_w": w // 2},
         ["X"], out1, ["Out"]),
        ("max_pool2d_with_index", {"X": [img]}, {"ksize": [2, 2],
                                                 "strides": [2, 2]}, ["X"],
         {"Out": 1, "Mask": 1}, ["Out"]),
        ("unpool", {"X": [img[:, :, ::2, ::2]], "Indices": [
            (np.arange(h // 2)[:, None] * 2 * w + np.arange(w // 2) * 2)
            .astype(np.int32) * np.ones((n, ch, 1, 1), np.int32)]},
         {"ksize": [2, 2], "strides": [2, 2], "unpooled_size": [h, w]},
         ["X"], out1, ["Out"]),
        ("spp", {"X": [img]}, {"pyramid_height": 3, "pooling_type": "max"},
         ["X"], out1, ["Out"]),
        ("im2sequence", {"X": [img[:2]]}, {"kernels": [3, 3],
                                            "strides": [2, 2],
                                            "paddings": [1, 1, 1, 1]},
         ["X"], out1, ["Out"]),
        ("norm", {"X": [img]}, {"axis": 1, "epsilon": 1e-10}, ["X"],
         {"Out": 1, "Norm": 1}, ["Out"]),
        ("label_smooth", {"X": [x]}, {"epsilon": 0.1}, ["X"], out1, ["Out"]),
        ("cos_sim", {"X": [x], "Y": [y]}, {}, ["X", "Y"],
         {"Out": 1, "XNorm": 1, "YNorm": 1}, ["Out"]),
    ]
    nn3d = [
        ("conv3d", {"Input": [vol], "Filter": [_xo(rng, 2 * vc, vc, 3, 3, 3)]},
         {"strides": [1, 1, 1], "paddings": [1, 1, 1], "groups": 1},
         ["Input", "Filter"], {"Output": 1}, ["Output"]),
        ("conv3d_transpose", {"Input": [vol], "Filter": [
            _xo(rng, vc, vc // 2, 2, 2, 2)]}, {"strides": [2, 2, 2],
                                        "paddings": [0, 0, 0], "groups": 1},
         ["Input", "Filter"], {"Output": 1}, ["Output"]),
        ("pool3d", {"X": [vol]}, {"pooling_type": "max", "ksize": [2, 2, 2],
                                  "strides": [2, 2, 2]}, ["X"], out1,
         ["Out"]),
        ("pool3d", {"X": [vol]}, {"pooling_type": "avg", "ksize": [4, 4, 4],
                                  "strides": [4, 4, 4]}, ["X"], out1,
         ["Out"]),
        ("max_pool3d_with_index", {"X": [vol]}, {"ksize": [2, 2, 2],
                                                 "strides": [2, 2, 2]},
         ["X"], {"Out": 1, "Mask": 1}, ["Out"]),
    ]
    return {"tensor": tensor, "math": math_ops, "loss": loss, "misc": misc,
            "nn": nn, "nn3d": nn3d}


def op_group_program(specs, seed):
    """One program holding every op of `specs`, the loss the sum of
    reduce_sum(out * cot) over the outputs each op's spec names, and its
    backward -> (main, feed, fetch names: every output, then the grads of
    the differentiable inputs)."""
    from paddle_tpu_torch import (Program, append_backward, layers,
                                  program_guard, unique_name)

    rng = np.random.RandomState(seed)
    main, startup = Program(), Program()
    feed, outs, grads, terms = {}, [], [], []
    with program_guard(main, startup), unique_name.guard():
        block = main.global_block()
        for k, (op_type, inputs, attrs, diff, out_params, read) in enumerate(
                specs):
            ivars = {}
            for p, arrs in inputs.items():
                ivars[p] = []
                for i, a in enumerate(arrs):
                    name = f"x{k}_{p}_{i}"
                    ivars[p].append(block.create_var(
                        name=name, shape=list(a.shape), dtype=str(a.dtype),
                        stop_gradient=p not in diff))
                    feed[name] = a
                    if p in diff:
                        grads.append(name + "@GRAD")
            ovars = {p: [block.create_var(name=f"y{k}_{p}_{i}",
                                          dtype="float32")
                         for i in range(cnt)]
                     for p, cnt in out_params.items()}
            block.append_op(type=op_type, inputs=ivars, outputs=ovars,
                            attrs=dict(attrs))
            for p, vs in ovars.items():
                for v in vs:
                    outs.append(v.name)
                    if p in read:
                        cot = block.create_var(name="cot_" + v.name,
                                               shape=list(v.shape),
                                               dtype="float32",
                                               stop_gradient=True)
                        feed[cot.name] = rng.standard_normal(
                            tuple(v.shape)).astype(np.float32)
                        terms.append(layers.reduce_sum(
                            layers.elementwise_mul(v, cot)))
        if terms:
            append_backward(layers.sums(terms) if len(terms) > 1
                            else terms[0])
    return main, feed, outs + grads


def _x_err(got, want):
    """Max abs difference over max(1, the largest |want|); an integer or
    bool output must be equal (err 0 or inf)."""
    if want.dtype.kind in "biu":
        return 0.0 if np.array_equal(got, want) else math.inf
    if want.size == 0:
        return 0.0
    w = want.astype(np.float64)
    return float(np.max(np.abs(got.astype(np.float64) - w))
                 / max(1.0, np.max(np.abs(w))))


def _run_group(exe, main, feed, fetch, runs):
    from paddle_tpu_torch import Scope

    scope = Scope()
    for _ in range(runs):
        outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    return outs


def phase_x_ops(card, device):
    """X/ops: each group of the dense tails' op types in one program, its
    backward included: the CPU path, the card's jit path (the first run
    eager, the second captured, the third a replay: compared with the CPU
    at X_TOL) and the card's interpreter (equal to the replay exactly),
    then X_REPS replays timed; the random group by its moments and jit =
    interpret, the host trio between segments."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope
    from paddle_tpu_torch.ops import registry

    rng = np.random.RandomState(SEED + 170)
    groups = _x_groups(rng)
    rows, seen = [], set()
    prev = torch.backends.cudnn.deterministic
    # the same convolution algorithm for the graph and the interpreter
    torch.backends.cudnn.deterministic = True
    try:
        for name, specs in groups.items():
            seen |= {s[0] for s in specs}
            main, feed, fetch = op_group_program(specs, SEED + len(name))
            dev_feed = {k: torch.as_tensor(v, device=device)
                        for k, v in feed.items()}
            want = _run_group(Executor(CPUPlace()), main, feed, fetch, 1)
            exe = Executor(CUDAPlace(0))
            cuda_sync()
            before = graph_stats()
            got = _run_group(exe, main, dev_feed, fetch, 3)
            ref = _run_group(Executor(CUDAPlace(0), mode="interpret"), main,
                             dev_feed, fetch, 3)
            errs = {n: _x_err(g, w) for n, g, w in zip(fetch, got, want)}
            worst = max(errs, key=errs.get)
            if errs[worst] > X_TOL:
                raise AssertionError(f"X/ops {name}: {worst} card vs CPU "
                                     f"{errs[worst]}")
            differ = [n for n, g, r in zip(fetch, got, ref)
                      if not np.array_equal(g, r, equal_nan=True)]
            if differ:
                raise AssertionError(f"X/ops {name}: jit != interpret for "
                                     f"{differ}")
            gs = graph_stats(before)
            if gs["captures"] < 1 or gs["replays"] < 1:
                raise AssertionError(f"X/ops {name}: graphs {gs}")
            scope = Scope()     # its first two runs warm up and capture
            for _ in range(2):
                exe.run(main, feed=dev_feed, fetch_list=fetch, scope=scope,
                        return_numpy=False)
            cuda_sync()
            t0 = time.perf_counter()
            for _ in range(X_REPS):
                exe.run(main, feed=dev_feed, fetch_list=fetch, scope=scope,
                        return_numpy=False)
            cuda_sync()
            ms = (time.perf_counter() - t0) / X_REPS * 1e3
            rows.append({"group": name, "op_types": sorted({s[0]
                                                            for s in specs}),
                         "outputs": len(fetch), "max_err": errs[worst],
                         "worst": worst, "ms": ms, "graphs": gs["captures"]})
            log(f"  X/ops {name}: {len(specs)} ops, {len(fetch)} outputs and "
                f"grads; card vs CPU max err {errs[worst]:.2e} ({worst}); "
                f"jit = interpret; {ms:.3f} ms a replay  [{card}]")
            del exe, got, ref, want, dev_feed
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = prev
    rows.append(phase_x_random(card, device))
    rows.append(phase_x_host(card, device))
    seen |= set(rows[-2]["op_types"]) | set(rows[-1]["op_types"])
    missing = sorted(set(X_NEW_OPS) - seen)
    if missing or not all(registry.is_registered(t) for t in X_NEW_OPS):
        raise AssertionError(f"X/ops: op types not driven: {missing}")
    return {"phase": "X/ops", "groups": rows, "op_types": len(seen),
            "card": card}


X_NEW_OPS = (
    "reshape2", "transpose", "transpose2", "split", "squeeze", "squeeze2",
    "unsqueeze", "unsqueeze2", "stack", "unstack", "expand", "pad", "pad2d",
    "scatter", "arg_max", "arg_min", "argsort", "shape", "fill",
    "fill_zeros_like", "range", "linspace", "where", "select", "diag",
    "reverse", "elementwise_floordiv", "cumsum", "pow", "isfinite", "isinf",
    "isnan", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "truncated_gaussian_random",
    "sampling_id", "smooth_l1_loss", "huber_loss", "log_loss", "hinge_loss",
    "rank_loss", "margin_rank_loss", "mse_loss", "kldiv_loss", "auc",
    "chunk_eval", "precision_recall", "positive_negative_pair", "flatten",
    "flatten2", "crop", "multiplex", "random_crop", "pad_constant_like",
    "is_empty", "minus", "l1_norm", "squared_l2_distance",
    "modified_huber_loss", "mean_iou", "affine_channel",
    "bilinear_tensor_product", "row_conv", "ctc_align", "conv_shift",
    "polygon_box_transform", "fused_elemwise_activation", "conv3d",
    "conv2d_transpose", "conv3d_transpose", "depthwise_conv2d_transpose",
    "pool3d", "max_pool2d_with_index", "max_pool3d_with_index", "unpool",
    "spp", "group_norm", "bilinear_interp", "nearest_interp", "im2sequence",
    "norm", "label_smooth", "cos_sim")


def phase_x_random(card, device):
    """The random group on the card: each draw's shape, range and moments,
    truncated_gaussian_random inside mean +- 2 std, sampling_id's
    frequencies, random_crop a window of its input; a replay draws anew,
    and the interpreter draws what the graph draws for the same run."""
    from paddle_tpu_torch import CUDAPlace, Executor

    r, c = XR_ROWS
    probs = np.tile(np.array([[0.1, 0.0, 0.6, 0.3]], np.float32), (r * 256, 1))
    crop_src = np.arange(8 * 64 * 64, dtype=np.float32).reshape(8, 64, 64)
    specs = [
        ("uniform_random_batch_size_like", {"Input": [np.zeros((r, 4),
                                                               np.float32)]},
         {"shape": [-1, c], "min": -2.0, "max": 3.0, "dtype": "float32"}, [],
         {"Out": 1}, []),
        ("gaussian_random_batch_size_like", {"Input": [np.zeros((r, 4),
                                                                np.float32)]},
         {"shape": [-1, c], "mean": 1.5, "std": 0.5, "dtype": "float32"}, [],
         {"Out": 1}, []),
        ("truncated_gaussian_random", {}, {"shape": [r, c], "mean": -1.0,
                                           "std": 2.0, "dtype": "float32"},
         [], {"Out": 1}, []),
        ("sampling_id", {"X": [probs]}, {}, [], {"Out": 1}, []),
        ("random_crop", {"X": [crop_src]}, {"shape": [40, 40]}, [],
         {"Out": 1}, []),
    ]
    main, feed, fetch = op_group_program(specs, SEED + 171)
    main.random_seed = SEED
    dev_feed = {k: torch.as_tensor(v, device=device) for k, v in feed.items()}
    exe = Executor(CUDAPlace(0))
    runs = [_run_group(exe, main, dev_feed, fetch, n) for n in (2, 3)]
    ref = _run_group(Executor(CUDAPlace(0), mode="interpret"), main,
                     dev_feed, fetch, 3)
    u, g, t, ids, crop = runs[1]
    checks = {k: bool(v) for k, v in {
        "uniform": u.shape == (r, c) and u.min() >= -2.0 and u.max() < 3.0
        and abs(u.mean() - 0.5) < 0.02 and abs(u.var() - 25 / 12) < 0.02,
        "gaussian": g.shape == (r, c) and abs(g.mean() - 1.5) < 0.005
        and abs(g.std() - 0.5) < 0.005,
        # a standard normal truncated to [-2, 2] has variance 0.77372
        "truncated": t.min() >= -5.0 and t.max() <= 3.0
        and abs(t.mean() + 1.0) < 0.02
        and abs(t.std() / 2.0 - math.sqrt(0.77372)) < 0.005,
        "sampling_id": np.allclose(np.bincount(ids, minlength=4) / ids.size,
                                   [0.1, 0.0, 0.6, 0.3], atol=0.01),
        "random_crop": crop.shape == (8, 40, 40) and np.array_equal(
            crop, crop_src[:, int(crop[0, 0, 0]) // 64:][:, :40,
                           int(crop[0, 0, 0]) % 64:][:, :, :40]),
        "replay_draws_anew": not np.array_equal(runs[0][0], u),
        "jit_equals_interpret": all(np.array_equal(a, b)
                                    for a, b in zip(runs[1], ref)),
    }.items()}
    if not all(checks.values()):
        raise AssertionError(f"X/ops random: {checks}")
    log(f"  X/ops random: {len(specs)} ops; uniform mean {u.mean():.4f} var "
        f"{u.var():.4f}, gaussian {g.mean():.4f} +- {g.std():.4f}, truncated "
        f"[{t.min():.3f}, {t.max():.3f}] std/2 {t.std() / 2:.4f}, sampling "
        f"{np.bincount(ids, minlength=4) / ids.size}; jit = interpret  "
        f"[{card}]")
    return {"group": "random", "op_types": [s[0] for s in specs],
            "checks": checks, "card": card}


def phase_x_host(card, device):
    """range, linspace and where on the card: the jit plan runs them on
    the host between two captured segments; equal to the CPU path."""
    from paddle_tpu_torch import (CPUPlace, CUDAPlace, Executor, Program,
                                  Scope, layers, program_guard)
    from paddle_tpu_torch.framework import executor as pexec

    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = layers.data(name="x", shape=[X_ROWS[1]], dtype="float32",
                        append_batch_size=False)
        y = layers.scale(x, scale=2.0)
        r = layers.tensor.range(0.0, float(X_ROWS[1]), 1.0, "float32")
        z = layers.elementwise_add(y, r)
        block = main.global_block()
        lin = block.create_var(name="lin", dtype="float32")
        block.append_op(type="linspace", inputs={
            "Start": [layers.fill_constant([1], "float32", -1.0)],
            "Stop": [layers.fill_constant([1], "float32", 1.0)],
            "Num": [layers.fill_constant([1], "int32", 257)]},
            outputs={"Out": [lin]})
        cond = layers.greater_than(z, layers.fill_constant([1], "float32",
                                                           600.0))
        pos = block.create_var(name="pos", dtype="int64")
        block.append_op(type="where", inputs={"Condition": [cond]},
                        outputs={"Out": [pos]})
    fetch = [z.name, "lin", "pos"]
    plan = pexec.build_plan(main, fetch)
    hosts = [main.global_block().ops[i].type for i in plan
             if not isinstance(i, pexec._Segment)]
    feed = {"x": np.random.RandomState(SEED + 172).standard_normal(
        X_ROWS[1]).astype(np.float32)}
    want = Executor(CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                    scope=Scope())
    got = _run_group(Executor(CUDAPlace(0)), main, feed, fetch, 3)
    if sorted(hosts) != ["linspace", "range", "where"] or any(
            _x_err(g, w) > X_TOL for g, w in zip(got, want)):
        raise AssertionError(f"X/ops host: plan {hosts}, errors "
                             f"{[_x_err(g, w) for g, w in zip(got, want)]}")
    log(f"  X/ops host: {hosts} on the host between "
        f"{sum(isinstance(i, pexec._Segment) for i in plan)} segments; "
        f"card = CPU ({len(got[2])} positions)  [{card}]")
    return {"group": "host", "op_types": ["range", "linspace", "where"],
            "plan_host_ops": hosts, "card": card}


def _encoder_program(cfg):
    from paddle_tpu_torch import Program, optimizer, program_guard, unique_name
    from paddle_tpu_torch.models import fluid_encoder

    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        loss, outs = fluid_encoder.build(cfg)
        optimizer.Adam(learning_rate=XA_LR).minimize(loss)
    return main, startup, loss, outs


def phase_x_attn(card, device):
    """X/attn: the primitive-level encoder at transformer-base width
    (models/fluid_encoder.base(): 6 layers, d_model 512, 8 heads of 64,
    the GLU 512 -> 4096 -> 2048 -> 512, sequence 256, float32, Adam,
    dropout 0): 3 steps at batch 8 on the card (captured from the second)
    against the port's CPU path from the same weights, then 3 steps jit
    against interpret (equal), then XA_STEPS captured steps at batch 64
    timed and XA_PROFILED profiled."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope
    from paddle_tpu_torch.models import fluid_encoder

    cfg = fluid_encoder.base()
    main, startup, loss, outs = _encoder_program(cfg)
    types = {op.type for op in main.global_block().ops}
    need = {"transpose", "reshape", "matmul", "softmax", "split", "arg_max",
            "layer_norm", "softmax_with_cross_entropy", "accuracy"}
    if not need <= types:
        raise AssertionError(f"X/attn: missing ops {sorted(need - types)}")
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    start = _persistables(scope, main)
    feed = fluid_encoder.synthetic_batch(XA_PARITY_BATCH, cfg, seed=SEED)
    probe = [outs["pred"], outs["acc"]]
    losses, first = run_steps(exe, main, scope, feed, loss, XA_PARITY_STEPS,
                              probe=probe)
    cpu_scope = Scope()
    for name, value in start.items():
        cpu_scope.set_var(name, value.cpu())
    t0 = time.perf_counter()
    cpu_losses, cpu_first = run_steps(Executor(CPUPlace()), main, cpu_scope,
                                      feed, loss, XA_PARITY_STEPS,
                                      probe=probe)
    cpu_s = time.perf_counter() - t0
    if not (np.all(np.isfinite(losses)) and np.allclose(
            losses, cpu_losses, rtol=XA_RTOL, atol=0)):
        raise AssertionError(f"X/attn: card losses {losses} vs CPU "
                             f"{cpu_losses}")
    if not np.array_equal(first[0].cpu().numpy(), cpu_first[0].numpy()):
        raise AssertionError("X/attn: argmax predictions differ")
    jit, ref = [], []
    eager = Executor(exe.device, mode="interpret")
    for _ in range(XA_PARITY_STEPS):
        ref += _interpret_step(eager, main, scope, feed, loss)
        jit += run_steps(exe, main, scope, feed, loss, 1)[0]
    if jit != ref:
        raise AssertionError(f"X/attn: jit losses {jit} vs interpret {ref}")
    del scope, cpu_scope, exe, eager
    torch.cuda.empty_cache()

    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = {k: torch.as_tensor(v, device=device) for k, v in
            fluid_encoder.synthetic_batch(XA_BATCH, cfg, seed=SEED + 1).items()}
    cuda_sync()
    _zero_counts()
    before = graph_stats()
    reset_peak_memory()
    warm, _ = run_steps(exe, main, scope, feed, loss, XA_WARMUP)
    cuda_sync()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, XA_STEPS)
    cuda_sync()
    wall = time.perf_counter() - t0
    prof = profile_calls(lambda: run_steps(exe, main, scope, feed, loss, 1),
                         XA_PROFILED, top=8)
    if not np.all(np.isfinite(warm + timed)):
        raise AssertionError(f"X/attn: losses {warm + timed}")
    graphs, bound = captured_graphs("X/attn", exe, feed)
    tokens = XA_BATCH * cfg.seq_len
    rate = tokens * XA_STEPS / wall
    fpt = fluid_encoder.flops_per_token(cfg)
    res = {"phase": "X/attn", "batch": XA_BATCH, "seq": cfg.seq_len,
           "layers": cfg.n_layer, "d_model": cfg.d_model,
           "heads": cfg.n_head, "parity_losses": losses,
           "parity_cpu_losses": cpu_losses, "cpu_s": cpu_s,
           "jit_losses": jit, "interpret_losses": ref,
           "losses": warm + timed, "tokens_per_s": rate,
           "ms_per_step": wall / XA_STEPS * 1e3, "flops_per_token": fpt,
           "mfu_f32": rate * fpt / PEAK_FLOP_PER_S[torch.float32],
           "launches": _port_kernel_counts(), "graphs": graphs,
           "bound_args": bound, "profile": prof, "card": card}
    res.update(capture_fields(before, prof, res["ms_per_step"]))
    log(f"  X/attn batch {XA_PARITY_BATCH}: card {losses} vs CPU "
        f"{cpu_losses} ({cpu_s:.1f} s on the CPU); jit {jit} = interpret")
    log(f"  X/attn batch {XA_BATCH}: {rate:.1f} tokens/s, "
        f"{res['ms_per_step']:.2f} ms/step, float32 MFU "
        f"{res['mfu_f32']:.4f}  [{card}]")
    log_capture("X/attn", res)
    log_profile(prof)
    return res


def _metric_run(build, feeds, fetch_of, place):
    """The metric program built by `build()` run over `feeds` on `place`
    (jit path; on the card captured from the second batch) -> the fetched
    values a batch."""
    from paddle_tpu_torch import Executor, Program, Scope, program_guard

    main, startup = Program(), Program()
    with program_guard(main, startup):
        fetch = fetch_of(build())
    scope, exe = Scope(), Executor(place)
    exe.run(startup, scope=scope)
    return [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]


def phase_x_metrics(card, device):
    """X/metrics: layers.auc over XM_AUC_BATCHES batches of XM_AUC_BATCH
    seeded predictions, its int64 stat vars equal the CPU path's at every
    batch and its AUC equal metrics.Auc fed the same batches (1e-6);
    chunk_eval under IOB and IOBES, its counts equal the CPU path's and
    metrics.ChunkEvaluator over them the op's own precision, recall and
    F1 (1e-6); precision_recall streamed through its states, equal to the
    CPU path's and to metrics.Precision / Recall on class 1 (1e-6)."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, layers, metrics

    cuda = CUDAPlace(0)
    rng = np.random.RandomState(SEED + 173)
    feeds = []
    for _ in range(XM_AUC_BATCHES):
        p1 = rng.rand(XM_AUC_BATCH).astype(np.float32)
        feeds.append({"pred": np.stack([1.0 - p1, p1], 1),
                      "label": (rng.rand(XM_AUC_BATCH, 1)
                                < p1[:, None]).astype(np.int64)})

    def auc_net():
        pred = layers.data(name="pred", shape=[2], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        return layers.auc(pred, label, num_thresholds=XM_AUC_THRESHOLDS)

    def auc_fetch(built):
        return [built[0]] + built[1]

    got = _metric_run(auc_net, feeds, auc_fetch, cuda)
    want = _metric_run(auc_net, feeds, auc_fetch, CPUPlace())
    host = metrics.Auc(num_thresholds=XM_AUC_THRESHOLDS)
    worst = 0.0
    for f, g, w in zip(feeds, got, want):
        host.update(f["pred"], f["label"])
        if not (np.array_equal(g[1], w[1]) and np.array_equal(g[2], w[2])
                and g[1].dtype == np.int64):
            raise AssertionError("X/metrics: auc stats differ from the CPU")
        worst = max(worst, abs(float(g[0][0]) - host.eval()))
    if worst > XM_AUC_TOL:
        raise AssertionError(f"X/metrics: auc vs metrics.Auc {worst}")
    res = {"phase": "X/metrics", "auc": float(got[-1][0][0]),
           "auc_vs_metrics_max_err": worst,
           "auc_samples": int(got[-1][1].sum() + got[-1][2].sum()),
           "card": card}
    log(f"  X/metrics auc: {XM_AUC_BATCHES} x {XM_AUC_BATCH} on the card, "
        f"stats = CPU exactly, AUC {res['auc']:.6f}, |AUC - metrics.Auc| "
        f"<= {worst:.2e}  [{card}]")

    for scheme in ("IOB", "IOBES"):
        b, t = XM_CHUNK_SHAPE
        ntag = {"IOB": 2, "IOBES": 4}[scheme]
        cfeeds = [{"inf": rng.randint(0, 3 * ntag + 1, (b, t)),
                   "lab": rng.randint(0, 3 * ntag + 1, (b, t)),
                   "lens": rng.randint(1, t + 1, (b,))}
                  for _ in range(XM_CHUNK_BATCHES)]

        def chunk_net(scheme=scheme):
            inf = layers.data(name="inf", shape=[t], dtype="int64")
            lab = layers.data(name="lab", shape=[t], dtype="int64")
            lens = layers.data(name="lens", shape=[], dtype="int64")
            return layers.chunk_eval(inf, lab, scheme, 3, seq_len=lens)

        got = _metric_run(chunk_net, cfeeds, list, cuda)
        want = _metric_run(chunk_net, cfeeds, list, CPUPlace())
        stream = metrics.ChunkEvaluator()
        for g, w in zip(got, want):
            if not all(np.array_equal(a, c) for a, c in zip(g[3:], w[3:])):
                raise AssertionError(f"X/metrics chunk_eval {scheme}: "
                                     "counts differ from the CPU")
            one = metrics.ChunkEvaluator()
            one.update(*g[3:])
            stream.update(*g[3:])
            err = max(abs(float(a[0]) - e)
                      for a, e in zip(g[:3], one.eval()))
            if err > XM_AUC_TOL:
                raise AssertionError(f"X/metrics chunk_eval {scheme}: op vs "
                                     f"metrics.ChunkEvaluator {err}")
        res[f"chunk_{scheme}"] = list(stream.eval())
        log(f"  X/metrics chunk_eval {scheme}: {XM_CHUNK_BATCHES} batches of "
            f"{b} x {t}, counts = CPU, the op's P/R/F1 = "
            f"metrics.ChunkEvaluator's; streamed {stream.eval()}")

    prec, rec = metrics.Precision(), metrics.Recall()
    states = {"cuda": np.zeros((2, 4), np.float32),
              "cpu": np.zeros((2, 4), np.float32)}
    from paddle_tpu_torch import Executor, Program, Scope, program_guard

    main, startup = Program(), Program()
    with program_guard(main, startup):
        block = main.global_block()
        ins = {p: [block.create_var(name=p, shape=s, dtype=d)]
               for p, s, d in (("Indices", [XM_PR_BATCH, 1], "int64"),
                               ("Labels", [XM_PR_BATCH, 1], "int64"),
                               ("StatesInfo", [2, 4], "float32"))}
        outs = {p: [block.create_var(name=p.lower(), dtype="float32")]
                for p in ("BatchMetrics", "AccumMetrics", "AccumStatesInfo")}
        block.append_op(type="precision_recall", inputs=ins, outputs=outs,
                        attrs={"class_number": 2})
    exes = {"cuda": Executor(cuda), "cpu": Executor(CPUPlace())}
    scopes = {"cuda": Scope(), "cpu": Scope()}
    for _ in range(XM_PR_BATCHES):
        pred = rng.randint(0, 2, (XM_PR_BATCH, 1)).astype(np.int64)
        lab = rng.randint(0, 2, (XM_PR_BATCH, 1)).astype(np.int64)
        prec.update(pred, lab)
        rec.update(pred, lab)
        for k in exes:
            states[k] = exes[k].run(main, feed={
                "Indices": pred, "Labels": lab, "StatesInfo": states[k]},
                fetch_list=["accumstatesinfo"], scope=scopes[k])[0]
        if not np.array_equal(states["cuda"], states["cpu"]):
            raise AssertionError("X/metrics precision_recall: states differ")
    tp, fp, fn = (float(states["cuda"][1, i]) for i in (0, 1, 3))
    err = max(abs(tp / (tp + fp) - prec.eval()),
              abs(tp / (tp + fn) - rec.eval()))
    if err > XM_AUC_TOL:
        raise AssertionError(f"X/metrics precision_recall vs metrics {err}")
    res["precision_recall_class1"] = [tp / (tp + fp), tp / (tp + fn)]
    log(f"  X/metrics precision_recall: {XM_PR_BATCHES} x {XM_PR_BATCH}, "
        f"states = CPU, class 1 P/R {res['precision_recall_class1']} = "
        f"metrics.Precision/Recall  [{card}]")
    return res


def drive_op_tails(card, device, lap=lambda phase: None):
    """[17]: X/ops, X/attn, X/metrics; none of the eight kernels
    launches."""
    _zero_counts()
    results = [phase_x_ops(card, device)]
    lap("[17] X/ops")
    torch.cuda.empty_cache()
    results.append(phase_x_attn(card, device))
    lap("[17] X/attn")
    torch.cuda.empty_cache()
    results.append(phase_x_metrics(card, device))
    lap("[17] X/metrics")
    launched = {k: n for k, n in _port_kernel_counts().items() if n}
    if launched:
        raise AssertionError(f"[17] launched port kernels: {launched}")
    return results


# ------------------------------------- [18] control flow and the sequence family

# CF/mt: the book's machine translation chapter (tests/book/
# test_machine_translation.py) at bench.py's machine_translation widths
# (bench.py:825-831): dict 10,000, T 24, batch 128; word dim and hidden 256
CM_DICT, CM_DIM, CM_HIDDEN, CM_T, CM_BATCH = 10000, 256, 256, 24, 128
CM_PARITY_STEPS, CM_STEPS, CM_PROFILED = 3, 5, 2
CM_RTOL = 1e-3            # card vs CPU losses
# the chapter's Adagrad, at a rate for these widths: at its 0.5 every
# weight moves by ~0.5 on the first step (Adagrad's g / |g|) and the
# loss climbs 9.2 -> 24 -> 34 in 3 steps, card and CPU 6% apart by the
# third (NVIDIA H100 80GB HBM3, 700 W); the JAX package's chapter climbs
# the same way on the CPU (tests/torch_mt_lr_witness.py)
CM_LR = 1e-3
CM_DECODE_BATCH, CM_BEAM, CM_MAX_LEN = 16, 4, 24
CM_BOS, CM_EOS = 0, 1
CM_DECODE_REPS = 3        # timed decodes (replays)
CF_RESCORE_TOL = 1e-4     # a beam's score vs its plain re-scoring, of
                          # max(1, |score|): a float32 sum of 24-32 steps
CF_MARGIN = 1e-4          # a step margin below which card and CPU may part
# CF/beam_lm: tests/test_decode.py:273-326's cached-attention LM at
# transformer-base width
CL_D, CL_HEADS, CL_VOCAB, CL_BATCH, CL_BEAM, CL_MAX_LEN = 512, 8, 32000, 8, 4, 32
CL_REPS = 3
# CF/while: tests/test_control_flow.py's While-with-parameter training,
# widened; card vs CPU within CF_TOL
CW_ROWS, CW_WIDTH, CW_TRIPS, CW_STEPS = 1024, 512, 16, 3
CF_TOL = 1e-5
# SEQ/ops: every sequence op of the slice on the card
SQ_B, SQ_T, SQ_D = 64, 128, 256


def _mt_encoder(L, pt):
    src = L.data(name="src_word_id", shape=[CM_T], dtype="int64")
    src_len = L.data(name="src_len", shape=[], dtype="int64")
    emb = L.embedding(input=src, size=[CM_DICT, CM_DIM],
                      param_attr=pt.ParamAttr(name="vemb"))
    seq, _, _ = L.lstm(emb, CM_HIDDEN,
                       param_attr=pt.ParamAttr(name="enc_lstm"))
    return L.sequence_last_step(seq, seq_len=src_len)


def _mt_step(L, pt, word, prev):
    state = L.fc(input=[word, prev], size=CM_HIDDEN, act="tanh",
                 param_attr=[pt.ParamAttr(name="dec_state_w"),
                             pt.ParamAttr(name="dec_state_u")],
                 bias_attr=pt.ParamAttr(name="dec_state_b"))
    score = L.fc(input=state, size=CM_DICT, act="softmax",
                 param_attr=pt.ParamAttr(name="dec_out_w"),
                 bias_attr=pt.ParamAttr(name="dec_out_b"))
    return state, score


def mt_train_program():
    """The chapter's `_build_train` (a DynamicRNN decoder over the LSTM
    encoder's last step) with its Adagrad (at CM_LR) and L2 decay 1e-4
    -> (main, startup, loss)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 17
    with pt.program_guard(main, startup), pt.unique_name.guard():
        context = _mt_encoder(L, pt)
        trg = L.data(name="trg_word_id", shape=[CM_T], dtype="int64")
        trg_len = L.data(name="trg_len", shape=[], dtype="int64")
        emb = L.embedding(input=trg, size=[CM_DICT, CM_DIM],
                          param_attr=pt.ParamAttr(name="trg_emb"))
        drnn = L.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(emb, seq_len=trg_len)
            prev = drnn.memory(init=context)
            state, score = _mt_step(L, pt, word, prev)
            drnn.update_memory(prev, state)
            drnn.output(score)
        label = L.data(name="trg_next_word", shape=[CM_T], dtype="int64")
        ce = L.cross_entropy(input=L.reshape(drnn(), shape=[-1, CM_DICT]),
                             label=L.reshape(label, shape=[-1, 1]))
        mask = L.reshape(L.cast(L.sequence_mask(trg_len, CM_T), "float32"),
                         shape=[-1, 1])
        loss = L.elementwise_div(L.reduce_sum(L.elementwise_mul(ce, mask)),
                                 L.reduce_sum(mask))
        pt.optimizer.Adagrad(
            learning_rate=CM_LR,
            regularization=pt.regularizer.L2DecayRegularizer(1e-4),
        ).minimize(loss)
    return main, startup, loss


def mt_decode_program():
    """The chapter's `_build_infer` at batch CM_DECODE_BATCH, beam CM_BEAM
    and CM_MAX_LEN steps: the context tiled to B*K and decoded by a
    BeamSearchDecoder carrying the decoder state -> (main, startup, ids,
    scores, the tiled context)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L

    batch, beam, max_len = CM_DECODE_BATCH, CM_BEAM, CM_MAX_LEN
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 17
    with pt.program_guard(main, startup), pt.unique_name.guard():
        context = _mt_encoder(L, pt)
        tiled = L.reshape(L.expand(L.reshape(context,
                                             shape=[-1, 1, CM_HIDDEN]),
                                   expand_times=[1, beam, 1]),
                          shape=[-1, CM_HIDDEN])
        dec = L.BeamSearchDecoder(beam_size=beam, max_len=max_len,
                                  bos_id=CM_BOS, eos_id=CM_EOS,
                                  batch_size=batch)
        with dec.block():
            prev_ids = dec.prev_ids()
            prev_state = dec.memory(init=tiled)
            word = L.embedding(input=prev_ids, size=[CM_DICT, CM_DIM],
                               param_attr=pt.ParamAttr(name="trg_emb"))
            state, score = _mt_step(L, pt, word, prev_state)
            dec.update_memory(prev_state, state)
            dec.set_logits(L.log(score))
        ids, scores = dec()
    return main, startup, ids, scores, tiled


def mt_batch(seed, batch):
    """The chapter's copy task: the target is the source shifted by one."""
    rng = np.random.RandomState(seed)
    src = rng.randint(2, CM_DICT, size=(batch, CM_T)).astype("int64")
    src_len = rng.randint(2, CM_T + 1, size=(batch,)).astype("int64")
    trg = np.roll(src, 1, axis=1)
    trg[:, 0] = CM_BOS
    return {"src_word_id": src, "src_len": src_len, "trg_word_id": trg,
            "trg_len": src_len, "trg_next_word": src.copy()}


def _steps_bitwise(phase, exe, main, scope, feed, loss, n):
    """n steps, each run first by the interpreter in a scratch scope from
    the same persistables, then by the graph: the losses bitwise equal."""
    from paddle_tpu_torch import Executor

    eager = Executor(exe.device, mode="interpret")
    jit, ref = [], []
    for _ in range(n):
        ref += _interpret_step(eager, main, scope, feed, loss)
        jit += run_steps(exe, main, scope, feed, loss, 1)[0]
    if jit != ref:
        raise AssertionError(f"{phase}: jit losses {jit} vs interpret {ref}")
    return jit


def _beam_margins(scores_fn, batch, beam, max_len, bos, eos, vocab, dev):
    """A float64 beam search on `dev` over `scores_fn(prev tokens [B*K],
    step) -> log-probs [B*K, V]` as beam_search_decode runs it -> (ids
    [B, K, T], scores [B, K], each row's smallest step margin: the least
    gap between neighbours among the K + 1 best totals)."""
    tokens = torch.full((batch, beam, max_len + 1), bos, dtype=torch.int64,
                        device=dev)
    scores = torch.full((batch, beam), -1e30, dtype=torch.float64,
                        device=dev)
    scores[:, 0] = 0.0
    alive = torch.ones((batch, beam), dtype=torch.bool, device=dev)
    margin = torch.full((batch,), math.inf, dtype=torch.float64, device=dev)
    eos_only = torch.full((vocab,), -math.inf, dtype=torch.float64,
                          device=dev)
    eos_only[eos] = 0.0
    for t in range(max_len):
        logp = scores_fn(tokens[:, :, t].reshape(-1), t).reshape(
            batch, beam, vocab)
        logp = torch.where(alive[..., None], logp, eos_only)
        total = (scores[..., None] + logp).reshape(batch, -1)
        top, idx = torch.sort(total, dim=-1, descending=True, stable=True)
        gaps = (top[:, :beam] - top[:, 1:beam + 1])
        live = top[:, 1:beam + 1] > -1e29
        gaps = torch.where(live, gaps, torch.full_like(gaps, math.inf))
        margin = torch.minimum(margin, gaps.min(dim=1).values)
        scores, idx = top[:, :beam], idx[:, :beam]
        src = torch.div(idx, vocab, rounding_mode="floor")
        tok = idx % vocab
        tokens = torch.gather(tokens, 1,
                              src[..., None].expand(-1, -1, max_len + 1))
        tokens[:, :, t + 1] = tok
        alive = torch.gather(alive, 1, src) & (tok != eos)
        scores_fn.reorder(src)
    return tokens[..., 1:], scores, margin


def _rescore_err(rescored, scores):
    """max |rescored - score| / max(1, |rescored|) over the beams."""
    return ((rescored - scores.double()).abs()
            / rescored.abs().clamp_min(1.0)).max().item()


def _rescore(step_logp, ids, bos, eos):
    """Each beam's total log-prob under `step_logp(prev [N], t) -> [N, V]`
    (float64), eos ending a beam: [B, K]."""
    b, k, n = ids.shape
    flat = ids.reshape(b * k, n)
    prev = torch.full((b * k,), bos, dtype=torch.int64, device=ids.device)
    total = torch.zeros(b * k, dtype=torch.float64, device=ids.device)
    done = torch.zeros(b * k, dtype=torch.bool, device=ids.device)
    for t in range(n):
        lp = step_logp(prev, t).gather(1, flat[:, t:t + 1])[:, 0]
        total = total + torch.where(done, torch.zeros_like(lp), lp)
        done = done | (flat[:, t] == eos)
        prev = flat[:, t]
    return total.reshape(b, k)


class _MtScorer:
    """The chapter's decoder step in float64 on the card, from the
    scope's weights, over a state of B*K rows."""

    def __init__(self, scope, context):
        w = {n: scope.find_var(n).double() for n in (
            "trg_emb", "dec_state_w", "dec_state_u", "dec_state_b",
            "dec_out_w", "dec_out_b")}
        self.w, self.h0 = w, context.double()
        self.h = self.h0.clone()

    def start(self):
        self.h = self.h0.clone()
        return self

    def __call__(self, prev, t):
        w = self.w
        self.h = torch.tanh(w["trg_emb"][prev] @ w["dec_state_w"]
                            + self.h @ w["dec_state_u"] + w["dec_state_b"])
        logits = self.h @ w["dec_out_w"] + w["dec_out_b"]
        return torch.log_softmax(torch.log_softmax(logits, -1), -1)

    def reorder(self, src):
        b, k = src.shape
        idx = (torch.arange(b, device=src.device)[:, None] * k
               + src).reshape(-1)
        self.h = self.h[idx]


def phase_cf_mt(card, device):
    """CF/mt: the book's machine-translation chapter at bench.py's widths:
    CM_PARITY_STEPS captured steps on the card against the port's CPU
    path from the same weights (losses within CM_RTOL), as many steps jit
    against interpret (bitwise), CM_STEPS timed steps (examples/s) and
    CM_PROFILED profiled; then save_persistables, load_persistables into
    the decode program, and the beam decode at batch 16, beam 4, max_len
    24 (captured; tokens/s): each beam re-scored by a plain float64
    forward within CF_RESCORE_TOL, and the ids equal to the port's CPU
    decode and to a float64 search on every row whose step margins all
    exceed CF_MARGIN."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope, io
    from paddle_tpu_torch.framework.scope import scope_guard

    main, startup, loss = mt_train_program()
    feed_np = mt_batch(SEED + 180, CM_BATCH)
    feed = {k: torch.as_tensor(v, device=device) for k, v in feed_np.items()}
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    start = _persistables(scope, main)
    cpu_scope = Scope()
    for name, value in start.items():
        cpu_scope.set_var(name, value.cpu())
    before = graph_stats()
    losses, _ = run_steps(exe, main, scope, feed, loss, CM_PARITY_STEPS)
    cpu_losses, _ = run_steps(Executor(CPUPlace()), main, cpu_scope,
                              feed_np, loss, CM_PARITY_STEPS)
    if not np.allclose(losses, cpu_losses, rtol=CM_RTOL, atol=0):
        raise AssertionError(f"CF/mt: card losses {losses} vs CPU "
                             f"{cpu_losses}")
    jit = _steps_bitwise("CF/mt", exe, main, scope, feed, loss,
                         CM_PARITY_STEPS)
    cuda_sync()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, CM_STEPS)
    cuda_sync()
    wall = time.perf_counter() - t0
    prof = profile_calls(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                         scope=scope, return_numpy=False),
                         CM_PROFILED)
    graphs, _ = captured_graphs("CF/mt", exe, feed)
    gs = graph_stats(before)
    if gs["eager_segments"]:
        raise AssertionError(f"CF/mt: eager segments {gs}")
    train = {"losses": losses + jit + timed, "cpu_losses": cpu_losses,
             "examples_per_s": CM_BATCH * CM_STEPS / wall,
             "ms_per_step": wall / CM_STEPS * 1e3,
             "card_busy_ms_per_step": prof["busy_ms_per_step"] if prof
             else None,
             "idle_share": prof["idle_share"] if prof else None,
             "graphs": graphs}
    log(f"  CF/mt train: batch {CM_BATCH}, T {CM_T}, dict {CM_DICT}: "
        f"{train['examples_per_s']:.1f} examples/s "
        f"({train['ms_per_step']:.2f} ms/step), card busy "
        f"{train['card_busy_ms_per_step']} ms/step, idle share "
        f"{train['idle_share']}; losses card {losses} vs CPU {cpu_losses}; "
        f"jit = interpret bitwise over {CM_PARITY_STEPS} steps  [{card}]")

    path = _saved_dir("cf_mt_params")
    with scope_guard(scope):
        io.save_persistables(exe, path, main_program=main)
    del scope, cpu_scope, start
    torch.cuda.empty_cache()
    dmain, dstart, ids, scores, tiled = mt_decode_program()
    dfeed_np = {k: v for k, v in mt_batch(SEED + 181,
                                          CM_DECODE_BATCH).items()
                if k in ("src_word_id", "src_len")}
    dfeed = {k: torch.as_tensor(v, device=device)
             for k, v in dfeed_np.items()}
    results = {}
    for label, place in (("card", CUDAPlace(0)), ("cpu", CPUPlace())):
        dscope, dexe = Scope(), Executor(place)
        dexe.run(dstart, scope=dscope)
        with scope_guard(dscope):
            io.load_persistables(dexe, path, main_program=dmain)
        f = dfeed if label == "card" else dfeed_np
        results[label] = dexe.run(dmain, feed=f,
                                  fetch_list=[ids, scores, tiled],
                                  scope=dscope, return_numpy=False)
        if label == "card":
            card_scope, card_exe = dscope, dexe
    fetch = [ids, scores, tiled]
    before = graph_stats()
    for _ in range(2):      # capture, replay
        got = card_exe.run(dmain, feed=dfeed, fetch_list=fetch,
                           scope=card_scope, return_numpy=False)
    cuda_sync()
    t0 = time.perf_counter()
    for _ in range(CM_DECODE_REPS):
        got = card_exe.run(dmain, feed=dfeed, fetch_list=fetch,
                           scope=card_scope, return_numpy=False)
    cuda_sync()
    dwall = (time.perf_counter() - t0) / CM_DECODE_REPS
    gs = graph_stats(before)
    if gs["captures"] < 1 or gs["replays"] < CM_DECODE_REPS:
        raise AssertionError(f"CF/mt decode: graphs {gs}")
    eager_ids, eager_scores, context = results["card"]
    if not (torch.equal(got[0], eager_ids)
            and torch.equal(got[1], eager_scores)):
        raise AssertionError("CF/mt decode: captured != the first (eager) "
                             "decode")
    scorer = _MtScorer(card_scope, context)
    rescored = _rescore(scorer.start(), got[0], CM_BOS, CM_EOS)
    err = _rescore_err(rescored, got[1])
    if err > CF_RESCORE_TOL:
        raise AssertionError(f"CF/mt decode: re-scored beams off by {err}")
    ref_ids, _, margin = _beam_margins(scorer.start(), CM_DECODE_BATCH,
                                       CM_BEAM, CM_MAX_LEN, CM_BOS, CM_EOS,
                                       CM_DICT, device)
    clear = (margin > CF_MARGIN).cpu()
    differ = ((got[0].cpu() != results["cpu"][0])
              | (got[0] != ref_ids).cpu()).flatten(1).any(1)
    if (differ & clear).any():
        raise AssertionError(
            f"CF/mt decode: rows {torch.nonzero(differ & clear).tolist()} "
            "differ from the CPU decode or the float64 search with every "
            f"step margin above {CF_MARGIN}")
    toks = CM_DECODE_BATCH * CM_BEAM * CM_MAX_LEN
    decode = {"batch": CM_DECODE_BATCH, "beam": CM_BEAM,
              "max_len": CM_MAX_LEN, "ms": dwall * 1e3,
              "beam_tokens_per_s": toks / dwall,
              "rescore_max_err": err, "rows_clear": int(clear.sum()),
              "rows_differ": int(differ.sum()),
              "graphs": gs["captures"], "replays": gs["replays"]}
    log(f"  CF/mt decode: batch {CM_DECODE_BATCH} x beam {CM_BEAM} x "
        f"{CM_MAX_LEN} steps in {decode['ms']:.2f} ms "
        f"({decode['beam_tokens_per_s']:.0f} beam tokens/s), captured = "
        f"eager; re-scored within {err:.2e}; {decode['rows_clear']} of "
        f"{CM_DECODE_BATCH} rows clear of a {CF_MARGIN} margin, "
        f"{decode['rows_differ']} differ from the CPU decode or the "
        f"float64 search  [{card}]")
    shutil.rmtree(path, ignore_errors=True)
    return {"phase": "CF/mt", "train": train, "decode": decode,
            "card": card}


def beam_lm_program():
    """tests/test_decode.py:_build_beam_lm at transformer-base width: one
    attention layer of CL_HEADS heads over a KV cache carried (and
    reordered by source beam) as decoder state."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L

    d, v, k, b, n = CL_D, CL_VOCAB, CL_BEAM, CL_BATCH, CL_MAX_LEN
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED + 182
    with pt.program_guard(main, startup), pt.unique_name.guard():
        # N(0, 1) rows, as the test's randn table, drawn by the startup
        L.create_parameter(
            shape=[v, d], dtype="float32", name="lm_emb",
            default_initializer=pt.initializer.Normal(0.0, 1.0))
        cache0 = L.fill_constant(shape=[b * k, n, d], value=0.0,
                                 dtype="float32")
        len0 = L.fill_constant(shape=[b * k], value=0, dtype="int64")
        dec = L.BeamSearchDecoder(beam_size=k, max_len=n, bos_id=0,
                                  eos_id=v + 5, batch_size=b)
        with dec.block():
            prev = dec.prev_ids()
            ck, cv, ln = dec.memory(cache0), dec.memory(cache0), \
                dec.memory(len0)
            x = L.reshape(L.embedding(prev, size=[v, d],
                                      param_attr=pt.ParamAttr(
                                          name="lm_emb")),
                          shape=[-1, 1, d])
            q, kk, vv = (L.fc(input=x, size=d, num_flatten_dims=2,
                              bias_attr=False, name=nm)
                         for nm in ("lm_q", "lm_k", "lm_v"))
            ok, ov = L.kv_cache_append(ck, cv, kk, vv, ln)
            nl = L.increment(ln, value=1, in_place=False)
            att = L.fused_attention(q, ok, ov, CL_HEADS, causal=False,
                                    seq_len=nl)
            lg = L.fc(input=L.reshape(att, shape=[-1, d]), size=v,
                      bias_attr=False, name="lm_out")
            dec.set_logits(lg)
            dec.update_memory(ck, ok)
            dec.update_memory(cv, ov)
            dec.update_memory(ln, nl)
        ids, scores = dec()
    return main, startup, ids, scores


def _lm_rescore(w, ids):
    """tests/test_decode.py:_np_rescore in float64 on the card, over every
    beam at once, with CL_HEADS heads: [B, K]."""
    b, k, n = ids.shape
    flat = ids.reshape(b * k, n)
    d, h = CL_D, CL_HEADS
    dh = d // h
    prev = torch.zeros(b * k, dtype=torch.int64, device=ids.device)
    ks, vs = [], []
    total = torch.zeros(b * k, dtype=torch.float64, device=ids.device)
    for t in range(n):
        x = w["lm_emb"][prev]
        q = (x @ w["lm_q.w_0"]).reshape(-1, h, dh)
        ks.append((x @ w["lm_k.w_0"]).reshape(-1, h, dh))
        vs.append((x @ w["lm_v.w_0"]).reshape(-1, h, dh))
        kk, vv = torch.stack(ks, 1), torch.stack(vs, 1)
        s = torch.einsum("nhd,nthd->nht", q, kk) / math.sqrt(dh)
        att = torch.einsum("nht,nthd->nhd", torch.softmax(s, -1), vv)
        lg = att.reshape(-1, d) @ w["lm_out.w_0"]
        lp = torch.log_softmax(lg, -1)
        total = total + lp.gather(1, flat[:, t:t + 1])[:, 0]
        prev = flat[:, t]
    return total.reshape(b, k)


def phase_cf_beam_lm(card, device):
    """CF/beam_lm: the cached-attention LM decoded by beam_search_decode
    at transformer-base width.  The gate picks flash_decode (#6) at Sq 1
    over a CL_MAX_LEN-slot cache (Sk not a multiple of 128, so the
    single-block kernel refuses it): one launch a step, CL_MAX_LEN a
    decode, inside the captured beam body.  Each beam re-scored by a
    float64 forward within CF_RESCORE_TOL; captured = interpret."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope
    from paddle_tpu_torch.ops import attention_ops
    from paddle_tpu_torch.ops.cuda import flash_decode, mha_block

    main, startup, ids, scores = beam_lm_program()
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    # the gate reads shapes, dtype and device: one row of each on the card
    qd = torch.empty((1, 1, CL_D), device=device)
    kd = torch.empty((1, CL_MAX_LEN, CL_D), device=device)
    tier = attention_ops.backend_choice(qd, kd, CL_HEADS)
    if tier != "flash_decode":
        raise AssertionError(f"CF/beam_lm: the gate picks {tier}, "
                             "predicted flash_decode")
    ref = Executor(CUDAPlace(0), mode="interpret").run(
        main, fetch_list=[ids, scores], scope=scope, return_numpy=False)
    _zero_counts()
    before = graph_stats()
    calls = 2 + CL_REPS          # warm-up, capture, replays
    cuda_sync()
    for i in range(calls):
        if i == 2:
            cuda_sync()
            t0 = time.perf_counter()
        got = exe.run(main, fetch_list=[ids, scores], scope=scope,
                      return_numpy=False)
    cuda_sync()
    ms = (time.perf_counter() - t0) / CL_REPS * 1e3
    launches = {"flash_decode": flash_decode.launches,
                "mha_block": mha_block.launches}
    gs = graph_stats(before)
    if launches["flash_decode"] != calls * CL_MAX_LEN \
            or launches["mha_block"]:
        raise AssertionError(f"CF/beam_lm: launches {launches}, expected "
                             f"{calls} x {CL_MAX_LEN} flash_decode")
    if gs["captures"] < 1 or gs["replays"] < CL_REPS:
        raise AssertionError(f"CF/beam_lm: graphs {gs}")
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("CF/beam_lm: captured != interpret")
    w = {n: scope.find_var(n).double() for n in (
        "lm_emb", "lm_q.w_0", "lm_k.w_0", "lm_v.w_0", "lm_out.w_0")}
    err = _rescore_err(_lm_rescore(w, got[0]), got[1])
    if err > CF_RESCORE_TOL:
        raise AssertionError(f"CF/beam_lm: re-scored beams off by {err}")
    if not (got[1][:, :-1] >= got[1][:, 1:]).all():
        raise AssertionError("CF/beam_lm: beams not best first")
    toks = CL_BATCH * CL_BEAM * CL_MAX_LEN
    log(f"  CF/beam_lm: d {CL_D}, {CL_HEADS} heads, vocab {CL_VOCAB}, "
        f"batch {CL_BATCH} x beam {CL_BEAM} x {CL_MAX_LEN} steps: "
        f"{ms:.2f} ms a decode ({toks / ms * 1e3:.0f} beam tokens/s); "
        f"tier {tier}, {launches['flash_decode']} launches over {calls} "
        f"decodes; captured = interpret; re-scored within {err:.2e}  "
        f"[{card}]")
    return ({"phase": "CF/beam_lm", "tier": tier, "launches": launches,
             "decodes": calls, "ms": ms, "beam_tokens_per_s": toks / ms * 1e3,
             "rescore_max_err": err, "graphs": gs["captures"],
             "card": card},
            {"flash_decode": launches["flash_decode"]})


def while_train_program(bounded):
    """tests/test_control_flow.py's While-with-parameter training,
    widened: acc = x @ w, then CW_TRIPS trips of acc = tanh(acc @ w), the
    mean's SGD step.  `bounded`: the i < const pattern (max_steps
    inferred); else the limit passes through an add and the loop has no
    bound."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED + 183
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = L.data(name="wgx", shape=[CW_WIDTH], dtype="float32")
        w = L.create_parameter(shape=[CW_WIDTH, CW_WIDTH], dtype="float32",
                               name="wg_w")
        acc = L.mul(x, w)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=CW_TRIPS)
        if not bounded:
            limit = L.elementwise_add(
                limit, L.fill_constant(shape=[1], dtype="int64", value=0))
        cond = L.less_than(x=i, y=limit)
        wh = L.While(cond=cond)
        with wh.block():
            L.assign(L.tanh(L.mul(acc, w)), acc)
            L.increment(i, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        loss = L.mean(acc)
        pt.optimizer.SGD(learning_rate=0.05).minimize(loss)
    (wop,) = [op for op in main.global_block().ops if op.type == "while"]
    if bool(wop.attrs["max_steps"]) != bounded:
        raise AssertionError(f"CF/while: max_steps {wop.attrs['max_steps']}")
    return main, startup, loss


def _program_card_cpu(phase, main, startup, feed_np, fetch, runs=3,
                      tol=CF_TOL):
    """`fetch` after `runs` runs on the card's jit path, the card's
    interpreter and the port's CPU path, each from the card startup's
    weights: card = CPU within `tol` of max(1, |CPU|), jit = interpret
    bitwise.  -> (card values, graph stats of the jit runs)."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope

    scope0, exe0 = Scope(), Executor(CUDAPlace(0))
    exe0.run(startup, scope=scope0)
    start = _persistables(scope0, main)
    outs = {}
    for label, place, mode in (("jit", CUDAPlace(0), "jit"),
                               ("interpret", CUDAPlace(0), "interpret"),
                               ("cpu", CPUPlace(), None)):
        scope = Scope()
        for name, value in start.items():
            scope.set_var(name, value.clone() if label != "cpu"
                          else value.cpu())
        exe = Executor(place, mode=mode)
        before = graph_stats()
        for _ in range(runs):       # host feeds, as a user passes them
            got = exe.run(main, feed=feed_np, fetch_list=fetch, scope=scope)
        outs[label] = got
        if label == "jit":
            gs = graph_stats(before)
    for n, a, b, c in zip(fetch, outs["jit"], outs["interpret"],
                          outs["cpu"]):
        if not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"{phase}: {n} jit != interpret")
        if _x_err(a, c) > tol:
            raise AssertionError(f"{phase}: {n} card vs CPU {_x_err(a, c)}")
    return outs["jit"], gs


def phase_cf_while(card, device):
    """CF/while: While-with-parameter training bounded (a captured
    segment, predicated trips) and unbounded (an eager segment, counted
    in cuda_graph.STATS), card = CPU within CF_TOL and jit = interpret
    bitwise, ms a trip each way; the book's while_loop program; IfElse
    with a NaN in its untaken branch; a conditional_block built by hand,
    its flag on and off."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import CUDAPlace, Executor, Scope
    from paddle_tpu_torch import layers as L

    rng = np.random.RandomState(SEED + 184)
    feed = {"wgx": (rng.rand(CW_ROWS, CW_WIDTH) / CW_WIDTH).astype(
        np.float32)}
    rows = []
    for bounded in (True, False):
        label = "bounded" if bounded else "unbounded"
        main, startup, loss = while_train_program(bounded)
        got, gs = _program_card_cpu(f"CF/while {label}", main, startup, feed,
                                    [loss.name, "wg_w"], runs=CW_STEPS)
        if bounded and (gs["captures"] < 1 or gs["eager_segments"]):
            raise AssertionError(f"CF/while bounded: graphs {gs}")
        if not bounded and (gs["captures"] or gs["eager_segments"]
                            != CW_STEPS):
            raise AssertionError(f"CF/while unbounded: graphs {gs}, expected "
                                 f"{CW_STEPS} eager segments")
        scope, exe = Scope(), Executor(CUDAPlace(0))
        exe.run(startup, scope=scope)
        dfeed = {k: torch.as_tensor(v, device=device)
                 for k, v in feed.items()}
        for _ in range(2):
            exe.run(main, feed=dfeed, fetch_list=[loss], scope=scope)
        cuda_sync()
        t0 = time.perf_counter()
        for _ in range(CW_STEPS):
            exe.run(main, feed=dfeed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
        cuda_sync()
        ms = (time.perf_counter() - t0) / CW_STEPS * 1e3
        rows.append({"loop": label, "ms_per_step": ms,
                     "ms_per_trip": ms / CW_TRIPS, "graphs": gs["captures"],
                     "eager_segments": gs["eager_segments"],
                     "loss": float(got[0].reshape(-1)[0])})
        log(f"  CF/while {label}: {CW_TRIPS} trips of a [{CW_ROWS}, "
            f"{CW_WIDTH}] x [{CW_WIDTH}, {CW_WIDTH}] body and its grad, "
            f"{ms:.3f} ms a step, {ms / CW_TRIPS:.3f} ms a trip "
            f"({'captured' if bounded else 'eager segment'}: graphs "
            f"{gs['captures']}, eager segments {gs['eager_segments']}); "
            f"card = CPU, jit = interpret  [{card}]")

    book = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "book", "_programs")
    with open(os.path.join(book, "while_loop.main.json")) as f:
        d = json.load(f)
    with open(os.path.join(book, "while_loop.startup.json")) as f:
        ds = json.load(f)
    s_name = d["blocks"][0]["ops"][2]["outputs"]["Out"][0]
    (s,), _ = _program_card_cpu("CF/while book", pt.Program.from_dict(d),
                                pt.Program.from_dict(ds), {}, [s_name])
    if float(s[0]) != 45.0:
        raise AssertionError(f"CF/while book: s = {s}")

    def if_else():
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), pt.unique_name.guard():
            x = L.data("x", shape=[1], dtype="float32")
            cond = L.greater_than(x, L.fill_constant([CW_ROWS, 1],
                                                     "float32", 0.0))
            ie = L.IfElse(cond)
            with ie.true_block():
                ie.output(L.log(ie.input(x)))
            with ie.false_block():
                ie.output(L.scale(ie.input(x), scale=-1.0))
            (out,) = ie()
        return main, startup, out

    main, startup, out = if_else()
    xs = rng.randn(CW_ROWS, 1).astype(np.float32)
    (got,), _ = _program_card_cpu("CF/while IfElse", main, startup,
                                  {"x": xs}, [out.name])
    if not np.isfinite(got).all():
        raise AssertionError("CF/while IfElse: the untaken branch's NaN "
                             "leaked")

    # a block safe only where the flag holds: it gathers rows of x by idx
    # and scales by sqrt(s), fed out of range and negative with the flag
    # off (the gather is of a feed: its grad would add with atomics, and
    # jit = interpret is held bitwise)
    for flag in (True, False):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), pt.unique_name.guard():
            x = L.data("x", shape=[CW_ROWS, CW_WIDTH], dtype="float32",
                       append_batch_size=False)
            idx = L.data("idx", shape=[CW_ROWS], dtype="int64",
                         append_batch_size=False)
            sv = L.data("s", shape=[CW_ROWS, 1], dtype="float32",
                        append_batch_size=False)
            fl = L.data("flag", shape=[1], dtype="bool",
                        append_batch_size=False)
            w = L.create_parameter(shape=[CW_WIDTH, CW_WIDTH],
                                   dtype="float32", name="cb_w")
            parent = main.current_block()
            sub = main.create_block()
            y = L.elementwise_add(
                L.elementwise_mul(L.scale(L.tanh(L.mul(x, w)), scale=3.0),
                                  L.sqrt(sv)),
                L.gather(x, idx))
            main.rollback()
            res = parent.create_var(name="cb_out", shape=y.shape,
                                    dtype="float32")
            names = [x.name, idx.name, sv.name, w.name]
            parent.append_op(type="conditional_block",
                             inputs={"X": [x, idx, sv, w], "Cond": [fl]},
                             outputs={"Out": [res]},
                             attrs={"sub_block": sub, "x_names": names,
                                    "out_names": [y.name]},
                             infer_shape=False)
            closs = L.reduce_sum(L.elementwise_mul(res, res))
            pt.append_backward(closs)
        sign = 1 if flag else -1
        (o, g), gs = _program_card_cpu(
            f"CF/while conditional_block {flag}", main, startup,
            {"x": rng.randn(CW_ROWS, CW_WIDTH).astype(np.float32),
             "idx": (rng.randint(0, CW_ROWS, CW_ROWS) if flag else
                     CW_ROWS + rng.randint(0, 1 << 20, CW_ROWS)),
             "s": sign * (rng.rand(CW_ROWS, 1) + 0.5).astype(np.float32),
             "flag": np.array([flag])}, ["cb_out", "cb_w@GRAD"])
        if bool(np.abs(o).sum() > 0) != flag or gs["captures"] < 1 \
                or not np.isfinite(g).all():
            raise AssertionError(f"CF/while conditional_block {flag}: "
                                 f"graphs {gs}, grad finite "
                                 f"{np.isfinite(g).all()}")
    log(f"  CF/while book while_loop s = 45, IfElse finite over a NaN "
        f"branch, conditional_block on and off (off: its gather out of "
        f"range, its sqrt of a negative; grads finite): card = CPU, jit = "
        f"interpret, captured  [{card}]")
    return {"phase": "CF/while", "loops": rows, "card": card}


SEQ_NEW_OPS = (
    "sequence_conv", "sequence_softmax", "sequence_expand",
    "sequence_expand_as", "sequence_reverse", "sequence_slice",
    "sequence_mask", "sequence_pad", "sequence_unpad", "sequence_concat",
    "sequence_enumerate", "sequence_erase", "sequence_reshape",
    "sequence_scatter", "lod_reset")


def _seq_specs(rng):
    """Every sequence op of the slice at [SQ_B, SQ_T, SQ_D], ragged
    lengths, as op_group_program specs."""
    b, t, d = SQ_B, SQ_T, SQ_D
    x = _xo(rng, b, t, d)
    lens = rng.randint(1, t + 1, b).astype(np.int64)
    ids = rng.randint(0, 16, (b, t)).astype(np.int64)
    out1 = {"Out": 1}
    return [
        ("sequence_conv", {"X": [x], "SeqLen": [lens],
                           "Filter": [_xo(rng, 3 * d, d) / d]},
         {"contextLength": 3, "contextStart": -1, "contextStride": 1},
         ["X", "Filter"], out1, ["Out"]),
        ("sequence_softmax", {"X": [_xo(rng, b, t)], "SeqLen": [lens]}, {},
         ["X"], out1, ["Out"]),
        ("sequence_expand", {"X": [_xo(rng, b, d)], "Y": [x],
                             "SeqLen": [lens]}, {}, ["X"], out1, ["Out"]),
        ("sequence_expand_as", {"X": [_xo(rng, b, d)], "Y": [x],
                                "SeqLen": [lens]}, {}, ["X"], out1, ["Out"]),
        ("sequence_reverse", {"X": [x], "SeqLen": [lens]}, {}, ["X"],
         {"Y": 1}, ["Y"]),
        ("sequence_slice", {"X": [x],
                            "Offset": [rng.randint(0, t // 2, b)],
                            "Length": [rng.randint(1, t // 2, b)]}, {},
         ["X"], out1, ["Out"]),
        ("sequence_mask", {"X": [lens]}, {"maxlen": t,
                                          "out_dtype": "float32"}, [],
         {"Y": 1}, []),
        ("sequence_pad", {"X": [x], "SeqLen": [lens],
                          "PadValue": [np.asarray([0.5], np.float32)]},
         {"padded_length": t + 16}, ["X"], {"Out": 1, "Length": 1},
         ["Out"]),
        ("sequence_unpad", {"X": [x], "Length": [lens]}, {}, ["X"], out1,
         ["Out"]),
        ("sequence_concat", {"X": [x, _xo(rng, b, t // 2, d)],
                             "SeqLen": [lens, lens // 2]}, {}, ["X"],
         {"Out": 1, "OutLen": 1}, ["Out"]),
        ("sequence_enumerate", {"X": [ids], "SeqLen": [lens]},
         {"win_size": 4, "pad_value": -1}, [], out1, []),
        ("sequence_erase", {"X": [ids], "SeqLen": [lens]},
         {"tokens": [3, 7]}, [], {"Out": 1, "OutLen": 1}, []),
        ("sequence_reshape", {"X": [x], "SeqLen": [lens]},
         {"new_dim": d // 4}, ["X"], {"Out": 1, "OutLen": 1}, ["Out"]),
        ("sequence_scatter", {"X": [_xo(rng, b, t)],
                              # distinct ids a row: a repeated id adds
                              # with atomics, in no fixed order
                              "Ids": [np.stack([rng.permutation(t)[:32]
                                                for _ in range(b)])],
                              "Updates": [_xo(rng, b, 32)],
                              "SeqLen": [rng.randint(1, 33, b)]}, {}, [],
         out1, []),
        ("lod_reset", {"X": [x], "Y": [lens]}, {}, ["X"],
         {"Out": 1, "OutLen": 1}, ["Out"]),
    ]


def phase_seq_ops(card, device):
    """SEQ/ops: every sequence op of the slice, forward and grad, in one
    program: the card's jit path (warm-up, capture, replay) against the
    port's CPU path within X_TOL of max(1, the largest), integer outputs
    equal, and the card's interpreter equal to the replay bitwise."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor

    specs = _seq_specs(np.random.RandomState(SEED + 185))
    if sorted({s[0] for s in specs}) != sorted(SEQ_NEW_OPS):
        raise AssertionError("SEQ/ops: op types not driven")
    main, feed, fetch = op_group_program(specs, SEED + 186)
    dev_feed = {k: torch.as_tensor(v, device=device) for k, v in feed.items()}
    want = _run_group(Executor(CPUPlace()), main, feed, fetch, 1)
    before = graph_stats()
    got = _run_group(Executor(CUDAPlace(0)), main, dev_feed, fetch, 3)
    ref = _run_group(Executor(CUDAPlace(0), mode="interpret"), main,
                     dev_feed, fetch, 3)
    gs = graph_stats(before)
    errs = {n: _x_err(g, w) for n, g, w in zip(fetch, got, want)}
    worst = max(errs, key=errs.get)
    if errs[worst] > X_TOL:
        raise AssertionError(f"SEQ/ops: {worst} card vs CPU {errs[worst]}")
    differ = [n for n, g, r in zip(fetch, got, ref)
              if not np.array_equal(g, r, equal_nan=True)]
    if differ or gs["captures"] < 1:
        raise AssertionError(f"SEQ/ops: jit != interpret for {differ}, "
                             f"graphs {gs}")
    log(f"  SEQ/ops: {len(specs)} op types, {len(fetch)} outputs and grads "
        f"at [{SQ_B}, {SQ_T}, {SQ_D}]: card vs CPU max err "
        f"{errs[worst]:.2e} ({worst}); jit = interpret  [{card}]")
    return {"phase": "SEQ/ops", "op_types": len(specs),
            "outputs": len(fetch), "max_err": errs[worst], "worst": worst,
            "card": card}


def drive_control_flow(card, device, lap=lambda phase: None):
    """[18]: CF/mt, CF/beam_lm, CF/while, SEQ/ops -> (records, launches).
    Only CF/beam_lm's beam body launches a port kernel (#6)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _zero_counts()
        runs = [phase_cf_mt(card, device)]
        lap("[18] CF/mt")
        _no_launches("CF/mt")
        torch.cuda.empty_cache()
        res, launches = phase_cf_beam_lm(card, device)
        runs.append(res)
        lap("[18] CF/beam_lm")
        _zero_counts()
        torch.cuda.empty_cache()
        runs.append(phase_cf_while(card, device))
        lap("[18] CF/while")
        runs.append(phase_seq_ops(card, device))
        lap("[18] SEQ/ops")
        _no_launches("CF/while, SEQ/ops")
    finally:
        torch.backends.cudnn.deterministic = prev
    return runs, launches


# ------------------------- [19] the recurrent tail and the sequence losses

# SRL/train: the reference label-semantic-roles chapter's db_lstm (Fluid's
# dynamic_lstm: an fc, then the raw `lstm` op with SeqLen and peepholes,
# candidate relu, gate and cell sigmoid) at the chapter's widths: word_dim
# 32, mark_dim 5, hidden_dim 512 (the lstm's 4 x 128 gates), depth 8, a
# 59-wide two-fc emission; conll05's dictionaries
# (paddle_tpu/dataset/conll05.py:12-15); the chapter's batch 10, lengths
# 4-29 as conll05 draws them, padded to T 30
SR_WORD, SR_PRED, SR_MARK, SR_LABEL = 44068, 3162, 2, 59
SR_WORD_DIM, SR_MARK_DIM, SR_HIDDEN, SR_DEPTH = 32, 5, 512, 8
SR_T, SR_BATCH = 30, 10
SR_LR, SR_CRF_LR = 0.01, 1e-3     # SGD; crfw's ParamAttr learning_rate
SR_PARITY_STEPS, SR_STEPS, SR_PROFILED = 3, 10, 2
SR_RTOL = 1e-3          # card vs CPU losses
SR_MARGIN = 1e-4        # a Viterbi step margin below which paths may part
SR_DECODE_REPS = 5
SR_SLOTS = ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
            "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data")
# RNN/fuse: the four fusions on programs at SRL/train's widths
RF_TOL = 1e-5           # transpiled vs not, of max(1, |x|)
# the op types the JAX package's InferenceTranspiler leaves on the same
# programs (tests/test_torch_rnn_fuse_passes.py records them on the CPU
# from rnn_fuse_programs and holds this table to them)
RF_JAX_TYPES = {
    "fc_lstm": ["fusion_lstm"],
    "fc_gru": ["fusion_gru"],
    "seqconv": ["fusion_seqconv_eltadd_relu"],
    "attention_lstm": ["fill_constant_batch_size_like",
                       "fill_constant_batch_size_like", "attention_lstm"],
}
# SEQ/tail: the 17 op types of the slice on the card
ST_B, ST_T, ST_M, ST_D = 64, 32, 256, 128
ST_TAGS, ST_CLASSES, ST_NEG = SR_LABEL, SR_WORD, 40
SEQ_TAIL_OPS = (
    "gru_unit", "gru", "lstm_unit", "lstm", "lstmp", "fusion_lstm",
    "fusion_gru", "attention_lstm", "fused_embedding_fc_lstm",
    "fusion_seqconv_eltadd_relu", "fusion_seqexpand_concat_fc",
    "linear_chain_crf", "crf_decoding", "warpctc", "edit_distance", "nce",
    "hierarchical_sigmoid")


def _layer_helper(name):
    from paddle_tpu_torch.layer_helper import LayerHelper

    return LayerHelper(name)


def srl_dynamic_lstm(x, size, seq_len, is_reverse=False):
    """Fluid's dynamic_lstm on a projected [B, T, size] input: Weight
    [size/4, size], Bias [1, 7 * size/4] (use_peepholes), the chapter's
    activations."""
    helper = _layer_helper("lstm")
    d = size // 4
    w = helper.create_parameter(attr=None, shape=[d, size], dtype="float32")
    b = helper.create_parameter(attr=None, shape=[1, 7 * d],
                                dtype="float32", is_bias=True)
    hidden, cell = (helper.create_variable_for_type_inference("float32")
                    for _ in range(2))
    helper.append_op(
        type="lstm",
        inputs={"Input": [x], "Weight": [w], "Bias": [b],
                "SeqLen": [seq_len]},
        outputs={"Hidden": [hidden], "Cell": [cell]},
        attrs={"use_peepholes": True, "is_reverse": is_reverse,
               "gate_activation": "sigmoid", "cell_activation": "sigmoid",
               "candidate_activation": "relu"})
    return hidden


def srl_program(word=SR_WORD, pred=SR_PRED, mark=SR_MARK, labels=SR_LABEL,
                word_dim=SR_WORD_DIM, mark_dim=SR_MARK_DIM,
                hidden=SR_HIDDEN, depth=SR_DEPTH, t=SR_T):
    """The chapter's training program (db_lstm, linear_chain_crf, SGD) with
    its crf_decoding -> (main, startup, loss, decoded, emission)."""
    from paddle_tpu_torch import (ParamAttr, Program, layers, optimizer,
                                  program_guard, unique_name)

    L = layers
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = SEED
    with program_guard(main, startup), unique_name.guard():
        feats = {n: L.data(name=n, shape=[t], dtype="int64")
                 for n in SR_SLOTS}
        seq_len = L.data(name="seq_len", shape=[], dtype="int64")
        embs = [L.embedding(input=feats[n], size=[word, word_dim],
                            param_attr=ParamAttr(name="emb",
                                                 trainable=False))
                for n in SR_SLOTS[:6]]
        embs.append(L.embedding(input=feats["verb_data"],
                                size=[pred, word_dim], param_attr="vemb"))
        embs.append(L.embedding(input=feats["mark_data"],
                                size=[mark, mark_dim]))
        hidden_0 = L.sums([L.fc(input=e, size=hidden, act="tanh",
                                num_flatten_dims=2) for e in embs])
        inputs = [hidden_0, srl_dynamic_lstm(hidden_0, hidden, seq_len)]
        for i in range(1, depth):
            mix = L.sums([L.fc(input=x, size=hidden, act="tanh",
                               num_flatten_dims=2) for x in inputs])
            inputs = [mix, srl_dynamic_lstm(mix, hidden, seq_len,
                                            is_reverse=i % 2 == 1)]
        emission = L.sums([L.fc(input=x, size=labels, act="tanh",
                                num_flatten_dims=2) for x in inputs])
        target = L.data(name="target", shape=[t], dtype="int64")
        loss = L.mean(L.linear_chain_crf(
            input=emission, label=target, seq_len=seq_len,
            param_attr=ParamAttr(name="crfw", learning_rate=SR_CRF_LR)))
        optimizer.SGD(learning_rate=SR_LR).minimize(loss)
        decoded = L.crf_decoding(input=emission, param_attr="crfw",
                                 seq_len=seq_len)
    return main, startup, loss, decoded, emission


def srl_batch(seed, batch=SR_BATCH, t=SR_T, word=SR_WORD, pred=SR_PRED,
              labels=SR_LABEL):
    """conll05's synthetic draw (paddle_tpu/dataset/conll05.py:32-50) of
    `batch` sentences, padded to t: words, the five context words and the
    predicate each repeated over the sentence, the one-hot mark, labels =
    word % 59."""
    rng = np.random.RandomState(seed)
    feed = {n: np.zeros((batch, t), np.int64) for n in SR_SLOTS}
    feed["target"] = np.zeros((batch, t), np.int64)
    lens = np.zeros(batch, np.int64)
    for i in range(batch):
        n = int(rng.randint(4, min(30, t + 1)))
        lens[i] = n
        words = rng.randint(0, word, n)
        feed["word_data"][i, :n] = words
        for slot in SR_SLOTS[1:6]:
            feed[slot][i, :n] = rng.randint(0, word)
        feed["verb_data"][i, :n] = rng.randint(0, pred)
        feed["mark_data"][i, int(rng.randint(0, n))] = 1
        feed["target"][i, :n] = words % labels
    feed["seq_len"] = lens
    return feed


def srl_emb(word=SR_WORD, dim=SR_WORD_DIM):
    """The chapter's pretrained table, here a seeded uniform(-0.1, 0.1)."""
    return np.random.RandomState(SEED + 190).uniform(
        -0.1, 0.1, (word, dim)).astype(np.float32)


def viterbi_margins(em, trans, lens):
    """float64 Viterbi over em [B, T, D] -> (paths [B, T], each row's
    smallest margin between the best and the second-best choice among
    the choices its path took: the last tag and each backpointer read)."""
    em, trans = em.astype(np.float64), trans.astype(np.float64)
    b, t, d = em.shape
    start, end, w = trans[0], trans[1], trans[2:]
    paths = np.zeros((b, t), np.int64)
    margins = np.full(b, np.inf)

    def gaps(v, axis):
        s = np.sort(v, axis=axis)
        return np.take(s, -1, axis=axis) - np.take(s, -2, axis=axis)

    for i in range(b):
        n = int(lens[i])
        if n == 0:
            continue
        delta, back, gap = start + em[i, 0], [], []
        for k in range(1, n):
            cand = delta[:, None] + w           # [from, to]
            back.append(cand.argmax(0))
            gap.append(gaps(cand, 0))
            delta = cand.max(0) + em[i, k]
        final = delta + end
        margins[i] = gaps(final, 0)
        tag = int(final.argmax())
        for k in range(n - 1, -1, -1):
            paths[i, k] = tag
            if k:
                margins[i] = min(margins[i], gap[k - 1][tag])
                tag = int(back[k - 1][tag])
    return paths, margins


def phase_srl(card, device):
    """SRL/train: the chapter at full width on the card's jit path, one
    captured graph a step: SR_PARITY_STEPS steps card vs CPU from the same
    weights (losses within SR_RTOL), as many jit vs interpret (bitwise),
    SR_STEPS timed (examples/s, live tokens/s), SR_PROFILED profiled.
    SRL/decode: crf_decoding with the trained weights, captured, its ids
    equal to the CPU's and to a float64 Viterbi on every row whose step
    margins exceed SR_MARGIN; the decode graph saved with
    save_inference_model and served by a Predictor on the card, its
    ViterbiPath equal to the in-process decode."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope, io
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.framework.scope import scope_guard

    reset_peak_memory()
    main, startup, loss, decoded, emission = srl_program()
    feed_np = srl_batch(SEED + 191)
    feed = {k: torch.as_tensor(v, device=device) for k, v in feed_np.items()}
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    scope.find_var("emb").copy_(torch.as_tensor(srl_emb(), device=device))
    start = _persistables(scope, main)
    cpu_scope = Scope()
    for name, value in start.items():
        cpu_scope.set_var(name, value.cpu())
    before = graph_stats()
    losses, _ = run_steps(exe, main, scope, feed, loss, SR_PARITY_STEPS)
    cpu_losses, _ = run_steps(Executor(CPUPlace()), main, cpu_scope,
                              feed_np, loss, SR_PARITY_STEPS)
    if not np.allclose(losses, cpu_losses, rtol=SR_RTOL, atol=0):
        raise AssertionError(f"SRL/train: card losses {losses} vs CPU "
                             f"{cpu_losses}")
    jit = _steps_bitwise("SRL/train", exe, main, scope, feed, loss,
                         SR_PARITY_STEPS)
    cuda_sync()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, SR_STEPS)
    cuda_sync()
    wall = time.perf_counter() - t0
    prof = profile_calls(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                         scope=scope, return_numpy=False),
                         SR_PROFILED)
    graphs, bound = captured_graphs("SRL/train", exe, feed)
    gs = graph_stats(before)
    if gs["eager_segments"] or graphs != 1:
        raise AssertionError(f"SRL/train: {graphs} graphs, {gs}")
    ms = wall / SR_STEPS * 1e3
    live = int(feed_np["seq_len"].sum())
    train = {"losses": losses + jit + timed, "cpu_losses": cpu_losses,
             "examples_per_s": SR_BATCH * SR_STEPS / wall,
             "live_tokens_per_s": live * SR_STEPS / wall,
             "ms_per_step": ms, "graphs": graphs, "bound": bound,
             "captures": gs["captures"],
             "eager_segments": gs["eager_segments"],
             "card_busy_ms_per_step": prof["busy_ms_per_step"] if prof
             else None,
             "idle_share": prof["idle_share"] if prof else None,
             "peak_mem_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
             "peak_reserved_mib":
                 torch.cuda.max_memory_reserved() / 2 ** 20}
    log(f"  SRL/train: batch {SR_BATCH}, T {SR_T} ({live} live tokens), "
        f"hidden {SR_HIDDEN}, depth {SR_DEPTH}, dict {SR_WORD}: "
        f"{train['examples_per_s']:.1f} examples/s, "
        f"{train['live_tokens_per_s']:.0f} live tokens/s ({ms:.2f} ms/step), "
        f"card busy {train['card_busy_ms_per_step']} ms/step, idle share "
        f"{train['idle_share']}; peak {train['peak_mem_mib']:.0f} MiB "
        f"allocated, {train['peak_reserved_mib']:.0f} MiB reserved; "
        f"{gs['captures']} captures, {gs['eager_segments']} eager segments; "
        f"losses card {losses} vs CPU {cpu_losses}; jit = interpret bitwise "
        f"over {SR_PARITY_STEPS} steps  [{card}]")

    # the test clone keeps the CRF cost, which reads `target`
    infer = main.clone(for_test=True)
    dfeed_np = {k: v for k, v in feed_np.items() if k != "target"}
    cpu_scope = Scope()
    for name, value in _persistables(scope, main).items():
        cpu_scope.set_var(name, value.cpu())
    cpu_path, = Executor(CPUPlace()).run(infer, feed=feed_np,
                                         fetch_list=[decoded],
                                         scope=cpu_scope)
    before = graph_stats()
    for _ in range(2):      # the eager run, the capture
        path, em = exe.run(infer, feed=feed, fetch_list=[decoded, emission],
                           scope=scope, return_numpy=False)
    cuda_sync()
    t0 = time.perf_counter()
    for _ in range(SR_DECODE_REPS):
        path, em = exe.run(infer, feed=feed, fetch_list=[decoded, emission],
                           scope=scope, return_numpy=False)
    cuda_sync()
    dms = (time.perf_counter() - t0) / SR_DECODE_REPS * 1e3
    gs = graph_stats(before)
    path = path.cpu().numpy()
    ref, margins = viterbi_margins(em.cpu().numpy(),
                                   scope.find_var("crfw").cpu().numpy(),
                                   feed_np["seq_len"])
    clear = margins > SR_MARGIN
    differ = ((path != cpu_path) | (path != ref)).any(axis=1)
    if (differ & clear).any() or gs["captures"] < 1:
        raise AssertionError(
            f"SRL/decode: rows {np.nonzero(differ & clear)[0].tolist()} "
            f"differ from the CPU decode or the float64 Viterbi with every "
            f"margin above {SR_MARGIN}; graphs {gs}")
    saved = _saved_dir("srl_decode")
    with scope_guard(scope):
        io.save_inference_model(saved, sorted(dfeed_np), [decoded], exe,
                                main_program=main)
    pred = inference.create_predictor(inference.Config(saved))
    for _ in range(2):
        served, = pred.run(dfeed_np)
    if not np.array_equal(served, path):
        raise AssertionError("SRL/decode: the Predictor's ViterbiPath != the "
                             "in-process decode")
    shutil.rmtree(saved, ignore_errors=True)
    decode = {"ms": dms, "rows_clear": int(clear.sum()),
              "rows_differ": int(differ.sum()),
              "min_margin": float(margins.min()), "graphs": gs["captures"]}
    log(f"  SRL/decode: crf_decoding over batch {SR_BATCH} x {SR_T} x "
        f"{SR_LABEL} tags in {dms:.3f} ms (captured); {decode['rows_clear']}"
        f" of {SR_BATCH} rows clear of a {SR_MARGIN} margin, "
        f"{decode['rows_differ']} differ from the CPU decode or the float64 "
        f"Viterbi; the Predictor on the card serves the same paths  "
        f"[{card}]")
    return {"phase": "SRL", "train": train, "decode": decode, "card": card}


def _fc3(x, size, bias=True):
    from paddle_tpu_torch import layers

    return layers.fc(x, size=size, num_flatten_dims=2,
                     bias_attr=None if bias else False)


def _raw_rnn(kind, proj, hidden):
    """A raw lstm (peepholes, default activations) or gru op."""
    helper = _layer_helper(f"raw_{kind}")
    mult = 4 if kind == "lstm" else 3
    w = helper.create_parameter(attr=None, shape=[hidden, mult * hidden],
                                dtype="float32")
    width = 7 * hidden if kind == "lstm" else mult * hidden
    b = helper.create_parameter(attr=None, shape=[width], dtype="float32",
                                is_bias=True)
    outs = {"Hidden": [helper.create_variable_for_type_inference("float32")]}
    extra = ("Cell",) if kind == "lstm" else ("BatchGate",
                                             "BatchResetHiddenPrev")
    for k in extra:
        outs[k] = [helper.create_variable_for_type_inference("float32")]
    helper.append_op(type=kind, inputs={"Input": [proj], "Weight": [w],
                                        "Bias": [b]}, outputs=outs,
                     attrs={"use_peepholes": True} if kind == "lstm" else {})
    return outs["Hidden"][0]


def _attention_lstm_rnn(x, s, m, hidden):
    """tests/test_attention_lstm_fuse.py's unfused additive-attention LSTM
    decoder over x [B, s, m]."""
    from paddle_tpu_torch import layers as L

    helper = _layer_helper("att_lstm_unfused")
    aw_x = helper.create_parameter(attr=None, shape=[m, 1], dtype="float32")
    aw_c = helper.create_parameter(attr=None, shape=[hidden, 1],
                                   dtype="float32")
    w_lstm = helper.create_parameter(attr=None, shape=[hidden + m,
                                                       4 * hidden],
                                     dtype="float32")
    b_lstm = helper.create_parameter(attr=None, shape=[4 * hidden],
                                     dtype="float32", is_bias=True)
    atted_x = L.reshape(L.mul(x, aw_x, x_num_col_dims=2), shape=[-1, s])
    rnn = L.StaticRNN()
    with rnn.step():
        rnn.step_input(x)
        h = rnn.memory(shape=[hidden], batch_ref=x, init_value=0.0)
        c = rnn.memory(shape=[hidden], batch_ref=x, init_value=0.0)
        score = L.relu(L.elementwise_add(x=atted_x, y=L.mul(c, aw_c),
                                         axis=0))
        pooled = L.reshape(L.matmul(L.reshape(L.softmax(score),
                                              shape=[-1, 1, s]), x),
                           shape=[-1, m])
        gates = L.elementwise_add(
            x=L.mul(L.concat([h, pooled], axis=1), w_lstm), y=b_lstm, axis=1)
        unit = _layer_helper("lstm_unit")
        h_new, c_new = (unit.create_variable_for_type_inference("float32")
                        for _ in range(2))
        unit.append_op(type="lstm_unit",
                       inputs={"X": [gates], "C_prev": [c]},
                       outputs={"H": [h_new], "C": [c_new]},
                       attrs={"forget_bias": 0.0})
        rnn.update_memory(h, h_new)
        rnn.update_memory(c, c_new)
        rnn.step_output(h_new)
    return rnn()


def rnn_fuse_programs(t=SR_T, width=SR_HIDDEN, hidden=SR_HIDDEN // 4):
    """{name: (main, startup, out)}: the four fusible chains, each on
    x [B, t, width]: fc -> lstm, fc -> gru, sequence_conv + bias + relu,
    and the attention-LSTM static_rnn."""
    from paddle_tpu_torch import Program, layers, program_guard, unique_name

    chains = {
        "fc_lstm": lambda x: _raw_rnn("lstm", _fc3(x, 4 * hidden), hidden),
        "fc_gru": lambda x: _raw_rnn("gru", _fc3(x, 3 * hidden), hidden),
        "seqconv": lambda x: layers.sequence_conv(
            x, num_filters=width, filter_size=3, act="relu"),
        "attention_lstm": lambda x: _attention_lstm_rnn(x, t, width,
                                                        hidden),
    }
    out = {}
    for name, chain in chains.items():
        main, startup = Program(), Program()
        main.random_seed = startup.random_seed = SEED
        with program_guard(main, startup), unique_name.guard():
            x = layers.data("x", shape=[t, width], dtype="float32")
            out[name] = (main, startup, chain(x))
    return out


def phase_rnn_fuse(card, device):
    """RNN/fuse: each fusion's program at SRL/train's widths on the card:
    the test clone's output before and after InferenceTranspiler (within
    RF_TOL of max(1, |x|)), its op types after the JAX package's
    (RF_JAX_TYPES), ms a captured replay before and after."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope
    from paddle_tpu_torch.transpiler import InferenceTranspiler

    x = torch.as_tensor(np.random.RandomState(SEED + 192).standard_normal(
        (SR_BATCH, SR_T, SR_HIDDEN)).astype(np.float32), device=device)
    rows = []
    for name, (main, startup, out) in rnn_fuse_programs().items():
        scope, exe = Scope(), Executor(CUDAPlace(0))
        exe.run(startup, scope=scope)
        infer = main.clone(for_test=True)
        timed = {}
        for when in ("before", "after"):
            if when == "after":
                InferenceTranspiler().transpile(infer, scope=scope)
            for _ in range(2):
                got, = exe.run(infer, feed={"x": x}, fetch_list=[out.name],
                               scope=scope, return_numpy=False)
            cuda_sync()
            t0 = time.perf_counter()
            for _ in range(X_REPS):
                got, = exe.run(infer, feed={"x": x}, fetch_list=[out.name],
                               scope=scope, return_numpy=False)
            cuda_sync()
            timed[when] = ((time.perf_counter() - t0) / X_REPS * 1e3,
                           got.cpu().numpy())
        types = [op.type for op in infer.global_block().ops]
        err = _x_err(timed["after"][1], timed["before"][1])
        if types != RF_JAX_TYPES[name] or err > RF_TOL:
            raise AssertionError(f"RNN/fuse {name}: op types {types} (the JAX "
                                 f"package's {RF_JAX_TYPES[name]}), "
                                 f"transpiled vs not {err}")
        rows.append({"chain": name, "types": types, "max_err": err,
                     "ms_before": timed["before"][0],
                     "ms_after": timed["after"][0]})
        log(f"  RNN/fuse {name}: -> {types}; transpiled vs not {err:.2e}; "
            f"{timed['before'][0]:.3f} ms a replay before, "
            f"{timed['after'][0]:.3f} after  [{card}]")
    return {"phase": "RNN/fuse", "chains": rows, "card": card}


def _st_groups(rng):
    """{group: op_group_program specs} of the slice's 17 op types."""
    b, t, m, d = ST_B, ST_T, ST_M, ST_D
    lens = rng.randint(1, t + 1, b).astype(np.int64)
    lens[0] = t

    def w(*shape):
        return _xo(rng, *shape) / math.sqrt(shape[0])

    x3 = _xo(rng, b, t, m)
    rnn = [
        ("gru_unit", {"Input": [_xo(rng, b, 3 * d)],
                      "HiddenPrev": [_xo(rng, b, d)],
                      "Weight": [w(d, 3 * d)], "Bias": [_xo(rng, 1, 3 * d)]},
         {"gate_activation": 1, "activation": 2},
         ["Input", "HiddenPrev", "Weight", "Bias"],
         {"Gate": 1, "ResetHiddenPrev": 1, "Hidden": 1}, ["Hidden"]),
        ("gru", {"Input": [_xo(rng, b, t, 3 * d)], "Weight": [w(d, 3 * d)],
                 "Bias": [_xo(rng, 1, 3 * d)], "H0": [_xo(rng, b, d)],
                 "SeqLen": [lens]}, {"is_reverse": True},
         ["Input", "Weight", "Bias", "H0"],
         {"Hidden": 1, "BatchGate": 1, "BatchResetHiddenPrev": 1},
         ["Hidden"]),
        ("lstm_unit", {"X": [_xo(rng, b, 4 * d)], "C_prev": [_xo(rng, b, d)]},
         {"forget_bias": 1.0}, ["X", "C_prev"], {"C": 1, "H": 1},
         ["C", "H"]),
        ("lstm", {"Input": [_xo(rng, b, t, 4 * d)], "Weight": [w(d, 4 * d)],
                  "Bias": [_xo(rng, 1, 7 * d)], "H0": [_xo(rng, b, d)],
                  "C0": [_xo(rng, b, d)], "SeqLen": [lens]},
         {"is_reverse": True, "use_peepholes": True,
          "candidate_activation": "relu", "cell_activation": "sigmoid"},
         ["Input", "Weight", "Bias", "H0", "C0"], {"Hidden": 1, "Cell": 1},
         ["Hidden"]),
        ("lstmp", {"Input": [_xo(rng, b, t, 4 * d)],
                   "Weight": [w(d // 2, 4 * d)],
                   "ProjWeight": [w(d, d // 2)], "Bias": [_xo(rng, 1, 4 * d)],
                   "SeqLen": [lens]}, {},
         ["Input", "Weight", "ProjWeight", "Bias"],
         {"Projection": 1, "Cell": 1}, ["Projection"]),
        ("fusion_lstm", {"X": [x3], "WeightX": [w(m, 4 * d)],
                         "WeightH": [w(d, 4 * d)],
                         "Bias": [_xo(rng, 1, 7 * d)]},
         {"use_peepholes": True, "is_reverse": True},
         ["X", "WeightX", "WeightH", "Bias"],
         {"Hidden": 1, "Cell": 1, "XX": 1}, ["Hidden"]),
        ("fusion_gru", {"X": [x3], "WeightX": [w(m, 3 * d)],
                        "WeightH": [w(d, 3 * d)],
                        "Bias": [_xo(rng, 1, 3 * d)]}, {},
         ["X", "WeightX", "WeightH", "Bias"], {"Hidden": 1, "XX": 1},
         ["Hidden"]),
        ("attention_lstm", {"X": [x3], "C0": [_xo(rng, b, d)],
                            "SeqLen": [lens],
                            "AttentionWeight": [w(m + d, 1)],
                            "LSTMWeight": [w(d + m, 4 * d)],
                            "LSTMBias": [_xo(rng, 1, 4 * d)]}, {},
         ["X", "C0", "AttentionWeight", "LSTMWeight", "LSTMBias"],
         {"Hidden": 1, "Cell": 1}, ["Hidden"]),
        ("fused_embedding_fc_lstm",
         {"Ids": [rng.randint(0, 1000, (b, t)).astype(np.int64)],
          "Embeddings": [_xo(rng, 1000, 4 * d)], "WeightH": [w(d, 4 * d)],
          "Bias": [_xo(rng, 1, 4 * d)]}, {"gate_layout": "cifo"},
         ["Embeddings", "WeightH"], {"Hidden": 1, "Cell": 1, "XX": 1},
         ["Hidden"]),
        ("fusion_seqconv_eltadd_relu",
         {"X": [x3], "Filter": [w(3 * m, d)], "Bias": [_xo(rng, 1, d)],
          "SeqLen": [lens]},
         {"contextLength": 3, "contextStart": -1, "contextStride": 1},
         ["X", "Filter", "Bias"], {"Out": 1, "ColMat": 1}, ["Out"]),
        ("fusion_seqexpand_concat_fc",
         {"X": [x3, _xo(rng, b, 64)], "FCWeight": [w(m + 64, d)],
          "FCBias": [_xo(rng, 1, d)], "SeqLen": [lens]},
         {"fc_activation": "tanh"}, ["X", "FCWeight", "FCBias"],
         {"Out": 1, "FCOut": 1}, ["Out"]),
    ]
    tags = ST_TAGS
    ctc_t, ctc_c, ctc_s = 50, 32, 10
    loss = [
        ("linear_chain_crf",
         {"Emission": [_xo(rng, b, t, tags)],
          "Transition": [_xo(rng, tags + 2, tags) * 0.1],
          "Label": [rng.randint(0, tags, (b, t)).astype(np.int64)],
          "SeqLen": [lens]}, {}, ["Emission", "Transition"],
         {"LogLikelihood": 1, "Alpha": 1, "EmissionExps": 1,
          "TransitionExps": 1}, ["LogLikelihood"]),
        ("warpctc",
         {"Logits": [_xo(rng, b, ctc_t, ctc_c)],
          "Label": [rng.randint(1, ctc_c, (b, ctc_s)).astype(np.int64)],
          "LogitsLength": [rng.randint(ctc_s * 2, ctc_t + 1, b)],
          "LabelLength": [rng.randint(1, ctc_s + 1, b)]},
         {"blank": 0, "norm_by_times": True}, ["Logits"], {"Loss": 1},
         ["Loss"]),
        ("hierarchical_sigmoid",
         {"X": [_xo(rng, 4 * b, 512)], "W": [_xo(rng, ST_CLASSES - 1, 512)
                                             / math.sqrt(512)],
          "Bias": [_xo(rng, ST_CLASSES - 1)],
          "Label": [rng.randint(0, ST_CLASSES, (4 * b, 1))]},
         {"num_classes": ST_CLASSES}, ["X", "W", "Bias"],
         {"Out": 1, "PreOut": 1}, ["Out"]),
    ]
    decode = [
        ("crf_decoding",
         {"Emission": [_xo(rng, b, t, tags)],
          "Transition": [_xo(rng, tags + 2, tags) * 0.1],
          "SeqLen": [lens]}, {}, [], {"ViterbiPath": 1}, []),
        ("crf_decoding",
         {"Emission": [_xo(rng, b, t, tags)],
          "Transition": [_xo(rng, tags + 2, tags) * 0.1],
          "Label": [rng.randint(0, tags, (b, t)).astype(np.int64)],
          "SeqLen": [lens]}, {}, [], {"ViterbiPath": 1}, []),
        ("edit_distance",
         {"Hyps": [rng.randint(0, 8, (b, t)).astype(np.int64)],
          "Refs": [rng.randint(0, 8, (b, t - 4)).astype(np.int64)],
          "HypsLength": [lens], "RefsLength": [rng.randint(0, t - 3, b)]},
         {"normalized": True}, [], {"Out": 1, "SequenceNum": 1}, []),
    ]
    return {"rnn": rnn, "loss": loss, "decode": decode}


def _nce_specs(rng, sampler):
    b, dim = 4 * ST_B, 512
    return [("nce",
             {"Input": [_xo(rng, b, dim)],
              "Label": [rng.randint(0, ST_CLASSES, (b, 1)).astype(np.int64)],
              "Weight": [_xo(rng, ST_CLASSES, dim) / math.sqrt(dim)],
              "Bias": [_xo(rng, ST_CLASSES) * 0.1]},
             {"num_total_classes": ST_CLASSES, "num_neg_samples": ST_NEG,
              "sampler": sampler}, ["Input", "Weight", "Bias"],
             {"Cost": 1, "SampleLogits": 1, "SampleLabels": 1}, ["Cost"])]


def _sampler_moments(sampler, c):
    cc = np.arange(c, dtype=np.float64)
    q = ((np.log(cc + 2) - np.log(cc + 1)) / np.log(c + 1)
         if sampler == "log_uniform" else np.full(c, 1.0 / c))
    mean = float((q * cc).sum())
    return q, mean, float((q * (cc - mean) ** 2).sum())


def phase_seq_tail(card, device):
    """SEQ/tail: the slice's 17 op types in four groups (the recurrent tail,
    the three losses, the two decoders, nce), each one program with its
    backward: the card's captured replay against the port's CPU path
    within X_TOL of max(1, the largest value), integer outputs equal, the
    card's interpreter equal to the replay bitwise; ms a replay.  nce:
    its negatives' mean and the share of class 0 within 5 standard
    errors of the sampler's, a replay draws anew, and its Cost and grads
    equal the CPU's pricing of the card's samples
    (testing.nce_given_samples)."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.ops import registry

    rng = np.random.RandomState(SEED + 193)
    groups = _st_groups(rng)
    for sampler in ("uniform", "log_uniform"):
        groups["nce_" + sampler] = _nce_specs(rng, sampler)
    seen = {s[0] for specs in groups.values() for s in specs}
    if sorted(seen) != sorted(SEQ_TAIL_OPS):
        raise AssertionError(f"SEQ/tail: op types {sorted(seen)}")
    rows = []
    for name, specs in groups.items():
        main, feed, fetch = op_group_program(specs, SEED + 194 + len(rows))
        main.random_seed = SEED
        dev_feed = {k: torch.as_tensor(v, device=device)
                    for k, v in feed.items()}
        exe = Executor(CUDAPlace(0))
        before = graph_stats()
        got = _run_group(exe, main, dev_feed, fetch, 3)
        ref = _run_group(Executor(CUDAPlace(0), mode="interpret"), main,
                         dev_feed, fetch, 3)
        gs = graph_stats(before)
        differ = [n for n, g, r in zip(fetch, got, ref)
                  if not np.array_equal(g, r, equal_nan=True)]
        if differ or gs["captures"] < 1:
            raise AssertionError(f"SEQ/tail {name}: jit != interpret for "
                                 f"{differ}, graphs {gs}")
        extra = {}
        if name.startswith("nce_"):
            samples = got[fetch.index("y0_SampleLabels_0")]
            info = registry.OPS["nce"]
            original = info.forward
            info.forward = testing.nce_given_samples(samples)
            try:
                want = _run_group(Executor(CPUPlace()), main, feed, fetch, 1)
            finally:
                info.forward = original
            scope = Scope()
            draws = [exe.run(main, feed=dev_feed,
                             fetch_list=["y0_SampleLabels_0"],
                             scope=scope)[0] for _ in range(2)]
            neg = samples[:, 1:].reshape(-1).astype(np.float64)
            q, mean, var = _sampler_moments(name[4:], ST_CLASSES)
            se_mean = math.sqrt(var / neg.size)
            share0 = float((neg == 0).mean())
            se0 = math.sqrt(q[0] * (1 - q[0]) / neg.size)
            extra = {"mean": float(neg.mean()), "want_mean": mean,
                     "share0": share0, "want_share0": float(q[0])}
            if (abs(neg.mean() - mean) > 5 * se_mean
                    or abs(share0 - q[0]) > 5 * se0
                    or np.array_equal(draws[0], draws[1])
                    or not np.array_equal(samples[:, 0],
                                          feed["x0_Label_0"][:, 0])):
                raise AssertionError(f"SEQ/tail {name}: draws {extra}")
        else:
            want = _run_group(Executor(CPUPlace()), main, feed, fetch, 1)
        errs = {n: _x_err(g, w) for n, g, w in zip(fetch, got, want)}
        worst = max(errs, key=errs.get)
        if errs[worst] > X_TOL:
            raise AssertionError(f"SEQ/tail {name}: {worst} card vs CPU "
                                 f"{errs[worst]}")
        scope = Scope()
        for _ in range(2):
            exe.run(main, feed=dev_feed, fetch_list=fetch, scope=scope,
                    return_numpy=False)
        cuda_sync()
        t0 = time.perf_counter()
        for _ in range(X_REPS):
            exe.run(main, feed=dev_feed, fetch_list=fetch, scope=scope,
                    return_numpy=False)
        cuda_sync()
        ms = (time.perf_counter() - t0) / X_REPS * 1e3
        rows.append(dict({"group": name, "op_types": sorted({s[0]
                                                             for s in specs}),
                          "outputs": len(fetch), "max_err": errs[worst],
                          "worst": worst, "ms": ms}, **extra))
        log(f"  SEQ/tail {name}: {len(specs)} ops, {len(fetch)} outputs and "
            f"grads; card vs CPU max err {errs[worst]:.2e} ({worst}); jit = "
            f"interpret; {ms:.3f} ms a replay"
            + (f"; negatives mean {extra['mean']:.1f} (sampler "
               f"{extra['want_mean']:.1f}), class 0 {extra['share0']:.4f} "
               f"({extra['want_share0']:.4f})" if extra else "")
            + f"  [{card}]")
        del exe, got, ref, want, dev_feed
        torch.cuda.empty_cache()
    return {"phase": "SEQ/tail", "groups": rows, "card": card}


def drive_recurrent_tail(card, device, lap=lambda phase: None):
    """[19]: SRL (train, decode), RNN/fuse, SEQ/tail; none of the eight
    kernels launches."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _zero_counts()
        runs = [phase_srl(card, device)]
        lap("[19] SRL")
        torch.cuda.empty_cache()
        runs.append(phase_rnn_fuse(card, device))
        lap("[19] RNN/fuse")
        runs.append(phase_seq_tail(card, device))
        lap("[19] SEQ/tail")
        _no_launches("SRL, RNN/fuse, SEQ/tail", "[19]")
    finally:
        torch.backends.cudnn.deterministic = prev
    return runs


def _no_launches(phases, tag="[18]"):
    launched = {k: n for k, n in _port_kernel_counts().items() if n}
    if launched:
        raise AssertionError(f"{tag} {phases} launched port kernels: "
                             f"{launched}")


# ------------------------------------------------------------ [20] MoE

# MoE/bench: bench.py's moe leg (bench.py:1451-1621): d_model 128, 2
# layers, 8 heads, 4 experts, top 2, capacity factor 1.25, vocab 4,000,
# batch 32 x seq 64, float32, Adam(1e-4), random_seed 1 (_setup), and the
# dense twin at the same FFN FLOPs a token (d_inner = top_k x d_model)
MB_BATCH, MB_SEQ, MB_DMODEL, MB_LAYERS = 32, 64, 128, 2
MB_EXPERTS, MB_TOPK, MB_CF, MB_VOCAB = 4, 2, 1.25, 4000
MB_WARMUP, MB_STEPS = 2, 20
MB_CHECK_STEPS, MB_LOSS_RTOL = 3, 1e-3    # card vs the port's CPU path
# its serving half: tiny_moe(vocab=200, max_length=16), 4 streams
MB_SRC, MB_PREFIX, MB_MAX_LEN, MB_NEW, MB_STREAMS, MB_VOCAB_S = (
    16, 4, 48, 16, 4, 200)
# MoE/ckpt: a save after step 3 of 6 with 4-shard placements
MK_STEPS, MK_AT, MK_SHARDS = 6, 3, 4
# MoE/base: transformer-base with every FFN a mixture of 8 experts of
# 2048 (the TransformerConfig defaults: top 2, capacity factor 1.25, aux
# weight 0.01) at T2's settings
MOE_EXPERTS = 8
MOE_WARMUP, MOE_STEPS, MOE_PROFILED = T2_WARMUP, T2_STEPS, T2_PROFILED
# a kernel of the expert products (cuBLAS's batched GEMMs) by its name
GEMM_NAMES = ("gemm", "Gemm", "xmma", "cutlass", "nvjet")
# the launches a call of each tier makes: training (forward and grad) and
# inference
TRAIN_LAUNCHES = {
    "mha_block": {"mha_block": 1, "mha_block_bwd": 1},
    "flash": {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 1,
              "flash_attention_bwd_dkv": 1}}
INFER_LAUNCHES = {
    "mha_block": {"mha_block": 1}, "mha_decode": {"mha_block": 1},
    "flash": {"flash_attention_fwd": 1},
    "flash_decode": {"flash_decode": 1}}


def _gate_tier(sq, sk, d, heads, causal, dtype, seq_len=False):
    """The tier the gate picks for one attention of these shapes (the gate
    reads shapes, dtype and device)."""
    from paddle_tpu_torch.ops import attention_ops

    q = torch.empty((1, sq, d), dtype=dtype, device="cuda")
    k = q if sk == sq else torch.empty((1, sk, d), dtype=dtype,
                                       device="cuda")
    return attention_ops.backend_choice(q, k, heads, causal,
                                        seq_len=seq_len)


def _gate_expect(calls, table):
    """[(tier, calls)] -> the launches of the eight kernels."""
    out = dict.fromkeys(KERNELS, 0)
    for tier, n in calls:
        for name, m in table.get(tier, {}).items():
            out[name] += m * n
    return out


def _train_tiers(cfg, seq, dtype):
    """A training step's attentions: [(tier, calls a step)]."""
    d, h, n = cfg.d_model, cfg.n_head, cfg.n_layer
    return [(_gate_tier(seq, seq, d, h, False, dtype), n),   # encoder
            (_gate_tier(seq, seq, d, h, True, dtype), n),    # decoder self
            (_gate_tier(seq, seq, d, h, False, dtype), n)]   # cross


def _moe_bench_cfgs():
    from paddle_tpu_torch.models import transformer

    common = dict(src_vocab_size=MB_VOCAB, trg_vocab_size=MB_VOCAB,
                  max_length=MB_SEQ, n_layer=MB_LAYERS, n_head=8,
                  d_model=MB_DMODEL, dropout=0.0)
    moe_cfg = transformer.TransformerConfig(
        d_inner=MB_DMODEL, moe_experts=MB_EXPERTS, moe_top_k=MB_TOPK,
        moe_capacity_factor=MB_CF, **common)
    dense_cfg = transformer.TransformerConfig(d_inner=MB_TOPK * MB_DMODEL,
                                              **common)
    return moe_cfg, dense_cfg


def build_moe_bench(cfg):
    """bench.py's _setup for the moe leg: random_seed 1, float32,
    transformer.build + Adam(1e-4)."""
    from paddle_tpu_torch import Program, optimizer, program_guard, unique_name
    from paddle_tpu_torch.models import transformer

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 1
    with program_guard(main, startup), unique_name.guard():
        loss = transformer.build(cfg)[0]
        optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return main, startup, loss


def _gating_ops(main):
    return [op for op in main.global_block().ops if op.type == "top_k_gating"]


def _host(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float64)


def _mb_feed(cfg, seed, device=None):
    from paddle_tpu_torch.models import transformer

    feed = transformer.synthetic_batch(MB_BATCH, cfg, seed=seed)
    if device is None:
        return feed
    return {k: torch.as_tensor(v, device=device) for k, v in feed.items()}


def _mb_train_leg(name, cfg, device):
    """One of bench.py's two training legs: 2 warm-up (eager, capture) and
    MB_STEPS timed replays; tokens/s = batch x seq x 2 x steps / wall."""
    main, startup, loss = build_moe_bench(cfg)
    scope, exe = _seeded_scope(main, startup)
    feed = _mb_feed(cfg, 0, device)
    warm, _ = run_steps(exe, main, scope, feed, loss, MB_WARMUP)
    cuda_sync()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, MB_STEPS)
    cuda_sync()
    wall = time.perf_counter() - t0
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"MoE/bench {name}: losses {losses}")
    captured_graphs(f"MoE/bench {name}", exe, feed)
    return {"tokens_per_s": MB_BATCH * MB_SEQ * 2 * MB_STEPS / wall,
            "ms_per_step": wall / MB_STEPS * 1e3, "first_loss": losses[0],
            "final_loss": losses[-1]}


def _softmax64(x):
    x = np.asarray(x, np.float64)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _routing_witness(card_probe, cpu_probe, n_gates):
    """Step 1's routing on the card against the CPU's: the share of
    (token, slot) assignments whose expert differs, per gating op, and at
    the first op where any differs the witness of each: the CPU's
    probabilities of the card's and the CPU's expert there may differ by
    no more than twice that op's largest card-vs-CPU probability
    difference (the two paths' float32 rounding could have ordered them
    either way).  Later ops see that op's changed outputs."""
    logits_c, logits_p = card_probe[:n_gates], cpu_probe[:n_gates]
    idx_c, idx_p = card_probe[n_gates:], cpu_probe[n_gates:]
    per_op, total, first = [], 0, None
    for g in range(n_gates):
        a = _host(idx_c[g]).astype(np.int64)
        b = _host(idx_p[g]).astype(np.int64)
        diff = a != b
        per_op.append(int(diff.sum()))
        total += a.size
        if first is not None or not diff.any():
            continue
        pc = _softmax64(_host(logits_c[g])).reshape(-1, MB_EXPERTS)
        pp = _softmax64(_host(logits_p[g])).reshape(-1, MB_EXPERTS)
        spread = float(np.abs(pc - pp).max())
        a, b = a.reshape(-1, MB_TOPK), b.reshape(-1, MB_TOPK)
        tok, slot = np.nonzero(a != b)
        gaps = np.abs(pp[tok, a[tok, slot]] - pp[tok, b[tok, slot]])
        first = {"op": g, "assignments": int(len(tok)),
                 "max_gap": float(gaps.max()), "spread": spread,
                 "witnessed": bool(gaps.max() <= 2 * spread)}
    return {"differ_share": sum(per_op) / total, "differ_per_op": per_op,
            "first": first}


def phase_moe_bench(card, device):
    """MoE/bench: bench.py's moe leg on the card -> (record, launches,
    the MoE program's pieces for MoE/ckpt)."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope, decode
    from paddle_tpu_torch import moe, serving
    from paddle_tpu_torch.models import transformer

    moe_cfg, dense_cfg = _moe_bench_cfgs()
    tiers = _train_tiers(moe_cfg, MB_SEQ, torch.float32)
    cuda_sync()
    _zero_counts()
    moe_leg = _mb_train_leg("moe", moe_cfg, device)
    dense_leg = _mb_train_leg("dense", dense_cfg, device)
    counts = _port_kernel_counts()
    steps = 2 * (MB_WARMUP + MB_STEPS)
    expect = _gate_expect([(t, n * steps) for t, n in tiers], TRAIN_LAUNCHES)
    if counts != expect:
        raise AssertionError(f"MoE/bench: launches {counts}, the gate "
                             f"predicts {expect} ({tiers})")

    # the drop rate at the training capacity factor: one eager step that
    # fetches every gating op's Load and Dropped
    main, startup, loss = build_moe_bench(moe_cfg)
    loads_n, dropped_n = moe.gating_fetches(main)
    scope, _ = _seeded_scope(main, startup)
    outs = Executor(CUDAPlace(0), mode="interpret").run(
        main, feed=_mb_feed(moe_cfg, 0, device),
        fetch_list=loads_n + dropped_n, scope=scope, return_numpy=False)
    loads = [_host(v) for v in outs[:len(loads_n)]]
    dropped = float(sum(_host(v).sum() for v in outs[len(loads_n):]))
    kept = float(sum(v.sum() for v in loads))
    drop_rate = dropped / max(1.0, kept + dropped)
    imbalance = max(float(v.max() / max(v.mean(), 1e-9)) for v in loads)

    # card vs the port's CPU path from the same weights, routing included
    gating = _gating_ops(main)
    probe = ([op.input("Logits")[0] for op in gating]
             + [op.output("Indices")[0] for op in gating])
    start = _persistables(scope, main)
    cpu_scope = Scope()
    for name, value in start.items():
        cpu_scope.set_var(name, value.cpu())
    exe = Executor(CUDAPlace(0))
    card_losses, card_probe = run_steps(exe, main, scope,
                                        _mb_feed(moe_cfg, 1, device), loss,
                                        MB_CHECK_STEPS, probe=probe)
    cpu_losses, cpu_probe = run_steps(Executor(CPUPlace()), main, cpu_scope,
                                      _mb_feed(moe_cfg, 1), loss,
                                      MB_CHECK_STEPS, probe=probe)
    del cpu_scope
    if not np.allclose(card_losses, cpu_losses, rtol=MB_LOSS_RTOL, atol=0):
        raise AssertionError(f"MoE/bench: card losses {card_losses} vs CPU "
                             f"{cpu_losses}")
    routing = _routing_witness(card_probe, cpu_probe, len(gating))
    if routing["first"] is not None and not routing["first"]["witnessed"]:
        raise AssertionError(f"MoE/bench: routing differs from the CPU's "
                             f"past float32 rounding: {routing}")

    # jit = interpret, bitwise, from the same weights
    _restore(scope, start)
    jit, ref = jit_vs_interpret("MoE/bench", Executor(CUDAPlace(0)), main,
                                scope, _mb_feed(moe_cfg, 2, device), loss,
                                MB_CHECK_STEPS)
    if jit != ref:
        raise AssertionError(f"MoE/bench: jit {jit} != interpret {ref}")

    # serving: the Scheduler against sequential generate(), bitwise
    dcfg = transformer.tiny_moe(vocab=MB_VOCAB_S, max_length=16,
                                experts=MB_EXPERTS, top_k=MB_TOPK)
    spec = decode_spec(dcfg, MB_PREFIX, MB_MAX_LEN, src_len=MB_SRC)
    dscope = Scope()
    gen = decode.Generator(spec, scope=dscope, place=CUDAPlace(0))
    feeds = [_bench_feed(MB_VOCAB_S, MB_SRC, MB_PREFIX, 500 + i)
             for i in range(MB_STREAMS)]
    sched = serving.Scheduler(spec, scope=dscope, place=CUDAPlace(0),
                              max_batch=MB_STREAMS)
    try:
        _warm_buckets(sched, lambda s: _bench_feed(MB_VOCAB_S, MB_SRC,
                                                   MB_PREFIX, s),
                      buckets=[MB_STREAMS])
        mon = spec.monitor.monitor
        seen = mon.steps
        cuda_sync()
        _zero_counts()
        c0 = dict(sched.counters)
        t0 = time.perf_counter()
        reqs = [sched.submit(f, MB_NEW, eos_id=-1) for f in feeds]
        sched.run_until_idle(max_steps=100000)
        cuda_sync()
        t_cb = time.perf_counter() - t0
        serve_counts = _port_kernel_counts()
        n_steps = sched.counters["steps"] - c0["steps"]
        n_prefills = (sched.counters["prefill_batches"]
                      - c0["prefill_batches"])
        observed = mon.steps - seen
        equal = check_served("MoE/bench serve", reqs, feeds, gen, MB_NEW)
        signal_ = mon.load_signal()
    finally:
        sched.close()
    d, h, n = dcfg.d_model, dcfg.n_head, dcfg.n_layer
    f32 = torch.float32
    serve_tiers = [
        (_gate_tier(MB_SRC, MB_SRC, d, h, False, f32, True), n * n_prefills),
        (_gate_tier(MB_PREFIX, MB_PREFIX, d, h, True, f32), n * n_prefills),
        (_gate_tier(MB_PREFIX, MB_SRC, d, h, False, f32, True),
         n * n_prefills),
        (_gate_tier(1, MB_MAX_LEN, d, h, False, f32, True), n * n_steps),
        (_gate_tier(1, MB_SRC, d, h, False, f32, True), n * n_steps)]
    serve_expect = _gate_expect(serve_tiers, INFER_LAUNCHES)
    if serve_counts != serve_expect:
        raise AssertionError(f"MoE/bench serve: launches {serve_counts}, "
                             f"the gate predicts {serve_expect}")
    if observed < n_steps or mon.total_dropped:
        raise AssertionError(f"MoE/bench serve: the monitor observed "
                             f"{observed} of {n_steps} steps, "
                             f"{mon.total_dropped} dropped")

    res = {"phase": "MoE/bench", "d_model": MB_DMODEL, "n_layer": MB_LAYERS,
           "experts": MB_EXPERTS, "top_k": MB_TOPK,
           "capacity_factor": MB_CF, "batch": MB_BATCH, "seq": MB_SEQ,
           "steps": MB_STEPS, "moe": moe_leg, "dense_equal_flops": dense_leg,
           "moe_tokens_per_s": moe_leg["tokens_per_s"],
           "dense_tokens_per_s": dense_leg["tokens_per_s"],
           "loss_gap": moe_leg["final_loss"] - dense_leg["final_loss"],
           "moe_drop_rate": drop_rate, "load_imbalance": imbalance,
           "gating_ops": len(loads_n), "card_losses": card_losses,
           "cpu_losses": cpu_losses, "routing": routing,
           "jit_losses": jit, "interpret_losses": ref,
           "serving": {"tokens_per_s": MB_STREAMS * MB_NEW / t_cb,
                       "requests_equal_to_sequential": equal,
                       "steps": n_steps, "prefill_batches": n_prefills,
                       "monitor_steps": observed, "load_signal": signal_},
           "launches": _add(counts, serve_counts), "card": card}
    log(f"  MoE/bench: moe {moe_leg['tokens_per_s']:.1f} tokens/s "
        f"({moe_leg['ms_per_step']:.2f} ms/step), dense twin "
        f"{dense_leg['tokens_per_s']:.1f} ({dense_leg['ms_per_step']:.2f}); "
        f"final losses {moe_leg['final_loss']:.6f} / "
        f"{dense_leg['final_loss']:.6f}, gap {res['loss_gap']:.6f}; "
        f"moe_drop_rate {drop_rate:.4f}, imbalance {imbalance:.3f} "
        f"({len(loads_n)} gating ops)  [{card}]")
    log(f"    card vs CPU losses {card_losses} / {cpu_losses}; routing "
        f"differs for {routing['differ_share']:.2e} of the assignments "
        f"{routing['differ_per_op']}, first: {routing['first']}; jit {jit} "
        f"= interpret; launches {counts} (the gate: {tiers})")
    log(f"    served {MB_STREAMS}x{MB_NEW}: "
        f"{res['serving']['tokens_per_s']:.1f} tokens/s, {equal}/"
        f"{MB_STREAMS} equal the sequential Generator, {n_steps} steps "
        f"({observed} observed), load_signal {signal_}, launches "
        f"{serve_counts}")
    del scope, dscope, gen
    torch.cuda.empty_cache()
    return res, res["launches"], (moe_cfg, loads)


def phase_moe_ckpt(card, device, moe_cfg, loads):
    """MoE/ckpt: MoE/bench's training with a CheckpointManager save after
    step MK_AT (the placements rebalanced by the drop-rate step's loads,
    epoch 1), restored into a fresh scope: the later steps' losses
    bitwise the uninterrupted run's, the placements' epochs adopted, and
    tools/ckpt_fsck.py (run by path) passes on the step directory."""
    from paddle_tpu_torch import moe
    from paddle_tpu_torch.checkpoint import CheckpointManager

    root = _saved_dir("moe_ckpt")
    feeds = [_mb_feed(moe_cfg, 10 + i, device) for i in range(MK_STEPS)]
    main, startup, loss = build_moe_bench(moe_cfg)
    scope, exe = _seeded_scope(main, startup)
    placements = moe.placements_for_program(main, MK_SHARDS)
    for placement, load in zip(placements.values(), loads, strict=True):
        placement.rebalance(load)
    mgr = CheckpointManager(root)
    losses = []
    for i, feed in enumerate(feeds):
        losses += run_steps(exe, main, scope, feed, loss, 1)[0]
        if i + 1 == MK_AT:
            t0 = time.perf_counter()
            path = mgr.save(MK_AT, scope=scope, main_program=main,
                            moe=placements)
            submit_s = time.perf_counter() - t0
    mgr.wait()
    fsck = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "ckpt_fsck.py"), path],
        capture_output=True, text=True, timeout=300)
    if fsck.returncode != 0:
        raise AssertionError(f"MoE/ckpt: ckpt_fsck rc {fsck.returncode}: "
                             f"{fsck.stdout[-2000:]} {fsck.stderr[-2000:]}")
    rmain, rstartup, rloss = build_moe_bench(moe_cfg)
    rscope, rexe = _seeded_scope(rmain, rstartup)
    fresh = moe.placements_for_program(rmain, MK_SHARDS)
    t0 = time.perf_counter()
    state = mgr.restore(scope=rscope, main_program=rmain, moe=fresh)
    restore_s = time.perf_counter() - t0
    resumed = []
    for feed in feeds[MK_AT:]:
        resumed += run_steps(rexe, rmain, rscope, feed, rloss, 1)[0]
    adopted = all(fresh[n].to_meta() == placements[n].to_meta()
                  for n in placements)
    epochs = sorted({p.epoch for p in fresh.values()})
    if resumed != losses[MK_AT:] or not adopted or epochs != [1] or \
            state["step"] != MK_AT:
        raise AssertionError(f"MoE/ckpt: resumed {resumed} vs "
                             f"{losses[MK_AT:]}, placements adopted "
                             f"{adopted}, epochs {epochs}")
    shutil.rmtree(root, ignore_errors=True)
    res = {"phase": "MoE/ckpt", "losses": losses, "resumed": resumed,
           "placements": len(fresh), "shards": MK_SHARDS,
           "placement_epochs": epochs, "fsck": fsck.stdout.splitlines()[0],
           "save_submit_ms": submit_s * 1e3, "restore_ms": restore_s * 1e3,
           "card": card}
    log(f"  MoE/ckpt: steps {MK_AT + 1}-{MK_STEPS} after the restore equal "
        f"the uninterrupted run's bitwise ({resumed}); {len(fresh)} "
        f"placements over {MK_SHARDS} shards adopted at epoch {epochs}; "
        f"ckpt_fsck: {res['fsck']}; save submit "
        f"{res['save_submit_ms']:.1f} ms, restore {res['restore_ms']:.1f} "
        f"ms  [{card}]")
    return res


def _interpret(main, scratch, feed, fetch):
    """One step by the interpreter -> the fetches (card tensors)."""
    from paddle_tpu_torch import CUDAPlace, Executor

    return Executor(CUDAPlace(0), mode="interpret").run(
        main, feed=feed, fetch_list=fetch, scope=scratch, return_numpy=False)


def moe_time_split(main, scope, feed, fetch):
    """One step by the interpreter under torch.profiler, each attention,
    gating and expert-FFN op (and its grad) inside a labelled range, the
    card synchronised around it: the card's ms a step in the attention
    ops, the gating, and the expert FFN split into its GEMMs (the expert
    products) and the rest (dispatch, combine, bias, activation).  A
    captured step runs no Python, so the split is taken where the ops run
    one by one: the same kernels.  -> (split, the step's fetches)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.ops import registry

    groups = {"attention": ("fused_attention",), "gating": ("top_k_gating",),
              "expert ffn": ("moe_expert_ffn",)}
    infos = [(label, info) for label, types in groups.items()
             for t in types
             for info in (registry.OPS[t], registry.get_runtime_info(
                 t + "_grad"))]
    real = [info.forward for _, info in infos]

    def labelled(fn, label):
        def run(ctx):
            cuda_sync()
            with record_function(label):
                fn(ctx)
                cuda_sync()
        return run

    scratch = _scratch(main, scope)
    for (label, info), fn in zip(infos, real):
        info.forward = labelled(fn, label)
    try:
        cuda_sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            outs = _interpret(main, scratch, feed, fetch)
            cuda_sync()
    finally:
        for (_, info), fn in zip(infos, real):
            info.forward = fn
        del scratch
        torch.cuda.empty_cache()
    spans = [sp for sp in device_spans(prof) if sp[0] not in groups]
    if not spans:
        return None, outs   # the profiler saw no device activity
    busy = busy_us(spans)
    split = {"step_busy_ms": busy / 1e3}
    for label in groups:
        ranges = [(e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name == label]
        mine = [sp for sp in spans if any(a <= sp[1] < b for a, b in ranges)]
        if label == "expert ffn":
            gemm = [sp for sp in mine if any(g in sp[0] for g in GEMM_NAMES)]
            rest = [sp for sp in mine if sp not in gemm]
            split["expert products_ms"] = busy_us(gemm) / 1e3
            split["dispatch/combine_ms"] = busy_us(rest) / 1e3
            top = {}
            for name, a, b in rest:
                top[name[:60]] = top.get(name[:60], 0.0) + (b - a) / 1e3
            split["dispatch/combine_top"] = sorted(
                ([k, round(v, 3)] for k, v in top.items()),
                key=lambda kv: -kv[1])[:5]
        else:
            split[f"{label}_ms"] = busy_us(mine) / 1e3
    split["other_ms"] = split["step_busy_ms"] - sum(
        v for k, v in split.items()
        if k.endswith("_ms") and k != "step_busy_ms")
    return split, outs


def phase_moe_base(card, device, t2):
    """MoE/base: transformer-base with every FFN a mixture at T2's
    settings (batch 128, seq 256, bf16 AMP, Adam multi_precision)."""
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops.moe_ops import expert_capacity

    cfg = transformer.TransformerConfig(max_length=SEQ, dropout=0.0,
                                        moe_experts=MOE_EXPERTS)
    main, startup, loss, params_grads = build_training(cfg, True, False)
    gating = _gating_ops(main)
    positions = [op.output("Positions")[0] for op in gating]
    loads_n = [op.output("Load")[0] for op in gating]
    dropped_n = [op.output("Dropped")[0] for op in gating]
    probe = positions + loads_n + dropped_n
    expert_grads = [g.name for p, g in params_grads
                    if "_moe_w" in p.name or "_gate.w_0" in p.name]
    tiers = _train_tiers(cfg, SEQ, torch.bfloat16)
    scope, exe = _seeded_scope(main, startup)
    feed = _train_feed(cfg, T2_BATCH, SEED + 40, False, device)
    ref_first = _f32_forward_loss(
        lambda: transformer.build(cfg, seq_len=SEQ)[0], scope, feed)
    torch.cuda.empty_cache()

    cuda_sync()
    _zero_counts()
    before = graph_stats()
    reset_peak_memory()
    warm, first = run_steps(exe, main, scope, feed, loss, MOE_WARMUP,
                            probe=probe)
    cuda_sync()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, MOE_STEPS,
                         probe=probe)
    cuda_sync()
    wall = time.perf_counter() - t0
    prof = profile_calls(
        lambda: run_steps(exe, main, scope, feed, loss, 1, probe=probe),
        MOE_PROFILED, top=8, kernels=("mha_block", "mha_block_bwd"))
    counts = _port_kernel_counts()
    n_steps = MOE_WARMUP + MOE_STEPS + MOE_PROFILED
    expect = _gate_expect([(t, n * n_steps) for t, n in tiers],
                          TRAIN_LAUNCHES)
    if counts != expect:
        raise AssertionError(f"MoE/base: launches {counts}, the gate "
                             f"predicts {expect} ({tiers})")
    res = capture_fields(before, prof, wall / MOE_STEPS * 1e3)
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"MoE/base: losses {losses}")
    if abs(losses[0] - ref_first) > LOSS_RTOL_BF16 * abs(ref_first):
        raise AssertionError(f"MoE/base: first loss {losses[0]} vs the "
                             f"float32 forward's {ref_first}")
    graphs, bound = captured_graphs("MoE/base", exe, feed)

    # the exact drop rate from the first step's Positions; Load and
    # Dropped are bfloat16 under AMP (exact to 256 only)
    n_tok = T2_BATCH * SEQ
    cap = expert_capacity(n_tok, MOE_EXPERTS, cfg.moe_top_k,
                          cfg.moe_capacity_factor)
    g = len(gating)
    exact = sum(int((p >= cap).sum().item()) for p in first[:g])
    bf16_dropped = sum(float(d.float().sum().item())
                       for d in first[2 * g:])
    bf16_kept = sum(float(v.float().sum().item()) for v in first[g:2 * g])
    assigned = g * n_tok * cfg.moe_top_k

    # the next step captured, then twice by the interpreter from the same
    # state (the second under the labelled profiler), once the captured
    # graphs and their pool are freed: the loss equal to the captured
    # replay's, the expert and router grads bitwise equal between the two
    snap = _scratch(main, scope)
    (jit_loss,), _ = run_steps(exe, main, scope, feed, loss, 1, probe=probe)
    exe._cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    fetch = [loss.name] + expert_grads
    a = [t.cpu() for t in _interpret(main, _scratch(main, snap), feed,
                                     fetch)]
    torch.cuda.empty_cache()
    split, b = moe_time_split(main, snap, feed, fetch)
    same = all(torch.equal(x, y.cpu()) for x, y in zip(a, b, strict=True))
    interp = float(a[0].float().reshape(-1)[0])
    del a, b, snap
    if not same or jit_loss != interp:
        raise AssertionError(f"MoE/base: interpreted step twice equal "
                             f"{same}; captured loss {jit_loss} vs "
                             f"interpreted {interp}")

    dense = transformer.TransformerConfig(
        max_length=SEQ, d_inner=cfg.moe_top_k * cfg.d_inner)
    tokens_per_s = 2 * T2_BATCH * SEQ * MOE_STEPS / wall
    res.update({
        "phase": "MoE/base", "dtype": "bfloat16 AMP", "batch": T2_BATCH,
        "seq": SEQ, "experts": MOE_EXPERTS, "top_k": cfg.moe_top_k,
        "capacity_factor": cfg.moe_capacity_factor, "capacity": cap,
        "warmup": MOE_WARMUP, "steps": MOE_STEPS, "losses": losses,
        "f32_forward_first_loss": ref_first, "launches": counts,
        "tokens_per_s": tokens_per_s, "ms_per_step": wall / MOE_STEPS * 1e3,
        "mfu_dense_twin": tokens_per_s * flops_per_token(dense)
        / PEAK_FLOP_PER_S[torch.bfloat16],
        "flops_per_token_dense_twin": flops_per_token(dense),
        "drop_rate_exact": exact / assigned, "dropped_exact": exact,
        "assigned": assigned, "dropped_bf16_sum": bf16_dropped,
        "kept_bf16_sum": bf16_kept, "graphs": graphs, "bound_args": bound,
        "profile": prof, "time_split_interpreted": split,
        "jit_loss": jit_loss, "interpret_loss": interp,
        "t2_tokens_per_s": t2.get("tokens_per_s"),
        "t2_ms_per_step": t2.get("ms_per_step"), "card": card})
    log(f"  MoE/base bf16 AMP batch {T2_BATCH}: {tokens_per_s:.1f} tokens/s, "
        f"{res['ms_per_step']:.2f} ms/step (T2 in this run: "
        f"{t2.get('tokens_per_s', float('nan')):.1f} tokens/s, "
        f"{t2.get('ms_per_step', float('nan')):.2f} ms/step), MFU of the "
        f"dense twin's FLOPs {res['mfu_dense_twin']:.4f} (the router's "
        f"2 d E a token left out); losses {losses}; float32 forward "
        f"{ref_first}; launches {counts}  [{card}]")
    log(f"    drop rate at cf {cfg.moe_capacity_factor} (C {cap}): exact "
        f"{exact}/{assigned} = {exact / assigned:.6f} from Positions; "
        f"bf16 Dropped sum {bf16_dropped}, Load sum {bf16_kept} (exact "
        f"kept {assigned - exact})")
    log(f"    interpreted step twice: grads of {len(expert_grads)} expert "
        f"and router weights bitwise equal; its loss {interp} = the "
        f"captured replay's {jit_loss}")
    log(f"    card ms a step, interpreted, by op: {split}")
    log_capture("MoE/base", res)
    log_profile(prof)
    del scope, exe
    torch.cuda.empty_cache()
    return res, counts


def phase_moe_serve(card):
    """MoE/serve: the MoE/base decode (capacity factor 0) through the
    Scheduler at batch 8 on the host pool and on the device pool, at
    [12] F/tax's shapes (32-token sources, 8-token prompts, 24 new
    tokens, a 96-slot cache): tokens equal the sequential Generator's,
    nothing dropped, every step observed by the load monitor, #6/#7
    launched as the gate predicts."""
    from paddle_tpu_torch import CUDAPlace, Scope, decode, serving
    from paddle_tpu_torch.models import transformer

    place = CUDAPlace(0)
    cfg = transformer.TransformerConfig(moe_experts=MOE_EXPERTS)
    spec = decode_spec(cfg, TAX_PREFIX, TAX_MAX_LEN, src_len=TAX_SRC)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = cfg.src_vocab_size
    scope = Scope()
    gen = decode.Generator(spec, scope=scope, place=place)
    mon = spec.monitor.monitor
    feeds = [_bench_feed(vocab, TAX_SRC, TAX_PREFIX, 700 + i)
             for i in range(TAX_STREAMS)]
    rows, counts = [], {}
    for paged in (False, True):
        label = "MoE/serve/paged" if paged else "MoE/serve"
        sched = serving.Scheduler(spec, scope, place=place,
                                  max_batch=TAX_STREAMS, block_size=S_BLOCK,
                                  paged_kv=paged)
        try:
            _warm_buckets(sched, lambda s: _bench_feed(vocab, TAX_SRC,
                                                       TAX_PREFIX, s))
            seen = mon.steps
            with _Counted(label, [sched], n_layer) as counted:
                t0 = time.perf_counter()
                reqs = [sched.submit(f, TAX_TOKENS, eos_id=-1)
                        for f in feeds]
                sched.run_until_idle(max_steps=100000)
                cuda_sync()
                wall = time.perf_counter() - t0
            observed = mon.steps - seen
            equal = check_served(label, reqs, feeds, gen, TAX_TOKENS)
            sched.pool.assert_quiesced()
        finally:
            sched.close()
        if observed != counted.steps or mon.total_dropped:
            raise AssertionError(f"{label}: the monitor observed "
                                 f"{observed} of {counted.steps} steps, "
                                 f"{mon.total_dropped} dropped")
        counts = _add(counts, counted.counts)
        row = {"phase": label, "paged_kv": paged, "streams": TAX_STREAMS,
               "new_tokens": TAX_TOKENS, "steps": counted.steps,
               "tokens_per_s": TAX_STREAMS * TAX_TOKENS / wall,
               "ms_per_step": wall / counted.steps * 1e3,
               "launches": counted.counts, "monitor_steps": observed,
               "load_signal": mon.load_signal(),
               "requests_equal_to_sequential": equal, "card": card}
        rows.append(row)
        log(f"  {label}: {TAX_STREAMS}x{TAX_TOKENS} tokens, "
            f"{row['tokens_per_s']:.1f} tokens/s, {row['ms_per_step']:.3f} "
            f"host ms a step over {counted.steps} steps (all observed, 0 "
            f"dropped); launches {counted.counts} = the gate's; {equal}/"
            f"{TAX_STREAMS} equal the sequential Generator; load_signal "
            f"{row['load_signal']}  [{card}]")
    del scope, gen
    torch.cuda.empty_cache()
    return rows, counts


def drive_moe(card, device, t2, lap=lambda phase: None):
    """[20]: MoE/bench, MoE/ckpt, MoE/base, MoE/serve."""
    runs = []
    res, launches, (moe_cfg, loads) = phase_moe_bench(card, device)
    runs.append(res)
    lap("[20] MoE/bench")
    runs.append(phase_moe_ckpt(card, device, moe_cfg, loads))
    lap("[20] MoE/ckpt")
    res, counts = phase_moe_base(card, device, t2)
    runs.append(res)
    launches = _add(launches, counts)
    lap("[20] MoE/base")
    rows, counts = phase_moe_serve(card)
    runs += rows
    launches = _add(launches, counts)
    lap("[20] MoE/serve")
    return runs, launches


# ------------------------------------------------------- [21] the mesh legs
#
# Three of __graft_entry__.py:69's dryrun_multichip legs at transformer-base
# width (its config, :43-45), each 3 float32 Adam steps on a 4-rank gloo
# world on this one card (NCCL refuses two ranks on one device), held to
# the port's single-process run on the card from the same weights and
# batches.  The rank-side functions run in the World's processes (they
# import this module by name).

MESH_RANKS, MESH_STEPS = 4, 3
MESH_LEGS = {
    # leg: (mesh axes, max_length = seq, global batch, build strategy,
    #       loss rtol: the dryrun's)
    "M/dp_tp": ({"dp": 2, "tp": 2}, 256, 16,
                {"reduce_strategy": 1, "tp": True}, 2e-4),
    "M/ring": ({"sp": 4}, 1024, 4, {}, 3e-4),
    "M/zero1": ({"dp": 2, "tp": 2}, 256, 16,
                {"zero_stage": 1, "tp": True}, 2e-4),
}
MESH_ZERO_RATIO = 0.55       # M/zero1: optimizer bytes a rank / one card's
RING_CHECK = (2, 1024, 8, 64)  # direct ring call: batch, seq, heads, head_dim
RING_LENS = (700, 1024)      # its key lengths (cross rank boundaries)


def mesh_cfg(seq, small=False):
    """transformer-base at the dryrun's vocab (__graft_entry__.py:43-45);
    `small` is a CPU rehearsal's width."""
    from paddle_tpu_torch.models import transformer as T

    if small:
        return T.TransformerConfig(
            src_vocab_size=64, trg_vocab_size=64, max_length=seq, n_layer=1,
            n_head=2, d_model=128, d_inner=256, dropout=0.0)
    return T.TransformerConfig(
        src_vocab_size=8000, trg_vocab_size=8000, max_length=seq,
        n_layer=6, n_head=8, d_model=512, d_inner=2048, dropout=0.0)


def _mesh_program(cfg):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import transformer as T

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup):
        with unique_name.guard():
            loss, _ = T.build(cfg)
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _param_checksum(scope, program):
    """float64 sum of |p| over the parameters: equal weights on every
    process."""
    from paddle_tpu_torch.framework.framework import Parameter

    total = 0.0
    for name, var in program.global_block().vars.items():
        if isinstance(var, Parameter):
            total += float(scope.find_var(name).double().abs().sum())
    return total


def _sync():
    if torch.cuda.is_available():
        cuda_sync()


def _attn_counts():
    from paddle_tpu_torch.ops.cuda import flash_attention, mha_block

    return {"mha_block": mha_block.launches,
            "mha_block_bwd": mha_block.bwd_launches,
            "flash_attention_fwd": flash_attention.launches,
            "flash_attention_bwd_dq": flash_attention.bwd_dq_launches,
            "flash_attention_bwd_dkv": flash_attention.bwd_dkv_launches}


def mesh_single(leg, device_type="cuda", small=False):
    """The port's single-process run of a leg's program on one device
    (its default jit path): the loss trajectory, seconds a step, the
    param checksum, optimizer-state bytes, peak memory."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework import Scope, scope_guard
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import memory

    axes, seq, batch, _, _ = MESH_LEGS[leg]
    cfg = mesh_cfg(seq, small)
    main, startup, loss = _mesh_program(cfg)
    place = fluid.CUDAPlace(0) if device_type == "cuda" else fluid.CPUPlace()
    scope = Scope()
    with scope_guard(scope):
        exe = fluid.Executor(place)
        exe.run(startup)
        checksum = _param_checksum(scope, main)
        memory.reset_peak()
        losses, secs = [], []
        for step in range(MESH_STEPS):
            feed = T.synthetic_batch(batch, cfg, seed=step)
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
            _sync()
            secs.append(time.perf_counter() - t0)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        return {"losses": losses, "s_per_step": secs, "checksum": checksum,
                "opt_bytes": memory.optimizer_state_bytes(scope, main),
                "peak_mib": memory.peak_bytes() / 2**20}


def mesh_rank_leg(leg, device_type="cuda", small=False):
    """One rank of a leg: the same program, startup and batches as
    mesh_single, through ParallelExecutor on the leg's mesh, each rank
    feeding its own rows."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework import Scope, scope_guard
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops import attention_ops
    from paddle_tpu_torch.parallel import (BuildStrategy, ParallelExecutor,
                                           comm, make_mesh, memory)
    import torch.distributed as dist

    axes, seq, batch, strategy, _ = MESH_LEGS[leg]
    cfg = mesh_cfg(seq, small)
    main, startup, loss = _mesh_program(cfg)
    place = fluid.CUDAPlace(0) if device_type == "cuda" else fluid.CPUPlace()
    bs = BuildStrategy()
    if strategy.get("tp"):
        bs.tensor_parallel_rules = T.tp_rules()
    if strategy.get("reduce_strategy"):
        bs.reduce_strategy = BuildStrategy.ReduceStrategy.Reduce
    bs.zero_stage = strategy.get("zero_stage", 0)
    scope = Scope()
    with scope_guard(scope):
        fluid.Executor(place).run(startup)
        checksum = _param_checksum(scope, main)
        pe = ParallelExecutor(loss_name=loss.name, main_program=main,
                              build_strategy=bs, scope=scope,
                              mesh=make_mesh(place=place, **axes))
        comm.reset_stats()
        memory.reset_peak()
        attention_ops.TIER_CALLS.clear()
        before = _attn_counts()
        losses, secs = [], []
        for step in range(MESH_STEPS):
            feed = {k: pe.local_batch(v) for k, v in
                    T.synthetic_batch(batch, cfg, seed=step).items()}
            t0 = time.perf_counter()
            (lv,) = pe.run(feed=feed, fetch_list=[loss.name])
            _sync()
            secs.append(time.perf_counter() - t0)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        after = _attn_counts()
        return {"rank": dist.get_rank(), "losses": losses,
                "s_per_step": secs, "checksum": checksum,
                "launches": {k: after[k] - before[k] for k in after},
                "tiers": dict(attention_ops.TIER_CALLS),
                "executor_mode": pe.executor_mode,
                "executor_mode_reason": pe.executor_mode_reason,
                "backend": str(dist.get_backend()),
                "comm": dict(comm.STATS),
                "opt_bytes": memory.optimizer_state_bytes(scope, main),
                "peak_mib": memory.peak_bytes() / 2**20}


def mesh_rank_ring_check(device_type="cuda", small=False):
    """A direct ring_attention call on an sp=4 mesh (causal, with global
    key lengths) against the single-device flash kernels on the same
    inputs: the forward against #3, the grads (the ring's #4/#5 per
    rotation) against #4/#5 over the whole sequence.  Returns the max abs
    errors of max(1, the largest reference value) (every rank computes
    the reference)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.ring_attention import (ring_attention,
                                                          ring_attention_grad)

    b, s, h, d = (1, 512, 1, 64) if small else RING_CHECK
    dev = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")
    place = fluid.CUDAPlace(0) if device_type == "cuda" else fluid.CPUPlace()
    g = torch.Generator(device="cpu").manual_seed(SEED)
    q, k, v, dout = (torch.randn((b, s, h * d), generator=g).to(dev)
                     for _ in range(4))
    lens = torch.tensor([min(x, s) for x in RING_LENS[:b]],
                        dtype=torch.int64, device=dev)
    mesh = make_mesh(place=place, sp=MESH_RANKS)
    before = _attn_counts()
    out = ring_attention(q, k, v, mesh, num_heads=h, causal=True,
                         seq_len=lens).full_tensor()
    grads = [x.full_tensor() for x in ring_attention_grad(
        q, k, v, dout, mesh, num_heads=h, causal=True, seq_len=lens)]
    after = _attn_counts()
    ref, lse = fa.flash_attention_lse(q, k, v, h, True, 0.0,
                                      kv_len=lens.float())
    want = fa.flash_attention_bwd(q, k, v, ref, lse, dout, h, True, 0.0,
                                  kv_len=lens.float())
    errs = {}
    for name, got, w in zip(("out", "dq", "dk", "dv"), [out] + grads,
                            [ref] + list(want)):
        errs[name] = float((got - w).abs().max()) / max(
            1.0, float(w.abs().max()))
    return {"errors": errs, "launches": {k: after[k] - before[k]
                                         for k in after}}


def phase_mesh(card, device, small=False):
    """[21]: the single-process references, then the 4-rank world: the
    direct ring check and the three legs."""
    import tempfile

    from paddle_tpu_torch.parallel import memory
    from paddle_tpu_torch.parallel.world import World

    device_type = device.type
    runs, launches = [], {}
    t0 = time.perf_counter()
    refs = {"M/dp_tp": mesh_single("M/dp_tp", device_type, small),
            "M/ring": mesh_single("M/ring", device_type, small)}
    refs["M/zero1"] = refs["M/dp_tp"]   # the same program and batches
    for name in ("M/dp_tp", "M/ring"):
        r = refs[name]
        log(f"  {name} single process: losses {r['losses']}, "
            f"{[round(x, 3) for x in r['s_per_step']]} s a step, peak "
            f"{r['peak_mib']:.0f} MiB, optimizer state {r['opt_bytes']} B")
    gc.collect()
    if device_type == "cuda":
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="mesh_")
    t1 = time.perf_counter()
    with World(MESH_RANKS, os.path.join(tmp, "rendezvous"),
               device_type=device_type, timeout=600) as world:
        spawn_s = time.perf_counter() - t1
        ring = world.run("chip_smoke:mesh_rank_ring_check", device_type,
                         small)
        errs = {k: max(r["errors"][k] for r in ring)
                for k in ring[0]["errors"]}
        log(f"  M/ring/check: ring_attention sp={MESH_RANKS}, causal, key "
            f"lengths {RING_LENS}, vs #3 forward / #4,#5 grads on one "
            f"device: max abs of max(1, |ref|) {errs}; launches per rank "
            f"{[r['launches'] for r in ring]}")
        if max(errs.values()) > TOL:
            raise AssertionError(f"M/ring/check: ring vs single-device "
                                 f"kernels {errs} > {TOL}")
        for name, (axes, seq, batch, strategy, rtol) in MESH_LEGS.items():
            t2 = time.perf_counter()
            ranks = world.run("chip_smoke:mesh_rank_leg", name, device_type,
                              small)
            leg_s = time.perf_counter() - t2
            ref = refs[name]
            for r in ranks:
                if abs(r["checksum"] - ref["checksum"]) > 1e-9 * abs(
                        ref["checksum"]):
                    raise AssertionError(
                        f"{name}: rank {r['rank']} started from other "
                        f"weights ({r['checksum']} vs {ref['checksum']})")
                np.testing.assert_allclose(
                    r["losses"], ref["losses"], rtol=rtol, atol=0,
                    err_msg=f"{name} rank {r['rank']} vs single process")
            worst = max(max(abs(a - b) / abs(b) for a, b in
                            zip(r["losses"], ref["losses"])) for r in ranks)
            res = {"phase": name, "mesh": axes, "seq": seq, "batch": batch,
                   "strategy": strategy, "losses": ranks[0]["losses"],
                   "single_losses": ref["losses"], "max_rel": worst,
                   "rtol": rtol,
                   "s_per_step": [r["s_per_step"] for r in ranks],
                   "single_s_per_step": ref["s_per_step"],
                   "launches": [r["launches"] for r in ranks],
                   "tiers": [r["tiers"] for r in ranks],
                   "executor_mode": ranks[0]["executor_mode"],
                   "executor_mode_reason": ranks[0]["executor_mode_reason"],
                   "backend": ranks[0]["backend"],
                   "comm": [r["comm"] for r in ranks],
                   "peak_mib": [r["peak_mib"] for r in ranks],
                   "single_peak_mib": ref["peak_mib"],
                   "opt_bytes": [r["opt_bytes"] for r in ranks],
                   "single_opt_bytes": ref["opt_bytes"],
                   "leg_s": leg_s, "card": card}
            res["opt_ratio"] = max(res["opt_bytes"]) / ref["opt_bytes"]
            log(f"  {name} {axes} seq {seq} batch {batch}: losses "
                f"{res['losses']} vs single {ref['losses']} (max rel "
                f"{worst:.2e} <= {rtol}); s a step per rank "
                f"{[[round(x, 3) for x in s] for s in res['s_per_step']]} "
                f"vs single {[round(x, 3) for x in ref['s_per_step']]}; "
                f"executor {res['executor_mode']} ({res['backend']}: "
                f"{res['executor_mode_reason']})")
            log(f"    launches per rank {res['launches']}; tiers "
                f"{res['tiers'][0]}; comm {res['comm']}; peak MiB per rank "
                f"{[round(x) for x in res['peak_mib']]} (single "
                f"{ref['peak_mib']:.0f}); optimizer bytes per rank "
                f"{res['opt_bytes']} vs single {ref['opt_bytes']} (ratio "
                f"{res['opt_ratio']:.3f}) [{card}]")
            want = (("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv") if name == "M/ring"
                    else ("mha_block", "mha_block_bwd"))
            if device_type == "cuda":
                dead = [(r["rank"], k) for r in ranks for k in want
                        if not r["launches"][k]]
                if dead:
                    raise AssertionError(f"{name}: kernels not launched on "
                                         f"every rank: {dead}")
            if name == "M/zero1" and res["opt_ratio"] > MESH_ZERO_RATIO:
                raise AssertionError(
                    f"M/zero1: optimizer bytes a rank {res['opt_ratio']:.3f}"
                    f" of one card's > {MESH_ZERO_RATIO}")
            for r in ranks:
                launches = _add(launches, r["launches"])
            runs.append(res)
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"  [21] references {ref_s:.1f} s, world start {spawn_s:.1f} s")
    return runs, launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    # float32 matmuls (the `mul` op, the plain versions, the composite)
    # must not round through TF32
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 is on")
    import paddle_tpu_torch  # noqa: F401  (fails alone, outside a checkout)
    from paddle_tpu_torch.ops.cuda import _build

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"[1] device {kind} x{count}; nvidia-smi: {card}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    info = _build.build()
    log(f"[2] built {sorted(info)} in {time.perf_counter() - t0:.1f} s wall")
    for name, rec in info.items():
        log(f"  {name}: nvcc {rec['seconds']:.1f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"    {line.strip()}")
    laps = [time.perf_counter()]

    def lap(step):
        laps.append(time.perf_counter())
        log(f"  {step} took {laps[-1] - laps[-2]:.1f} s wall")

    log(f"[3] kernels vs plain versions at the main path's shapes [{card}]")
    cases = check_kernels(device)
    lap("[3]")

    log(f"[4] serving: transformer.base() through decode.Generator, then "
        f"serving.Scheduler [{card}]")
    phases, launches, scope = drive_main_path(card)
    lap("[4]")

    log(f"[5] serving: transformer.base() through serving.Scheduler over "
        f"the device pool: phase S, then speculative decoding (V/trunc, "
        f"V/self), chunked prefill (C) and the two-tier handoff (H) [{card}]")
    res, counts = phase_s(card, scope)
    phases.append(res)
    more, more_counts = drive_scheduler_paths(card, scope)
    phases += more
    counts = _add(counts, more_counts)
    c10_line(phases, card)
    del scope
    torch.cuda.empty_cache()
    lap("[5]")

    log(f"[6] training: transformer.base() through Executor.run on the "
        f"jit path (T1, T2, T2/drop) [{card}]")
    training, train_launches = drive_training(card, device)
    lap("[6] T1, T2")
    res, drop_launches = phase_t2drop(card, device)
    training.append(res)
    train_launches = _add(train_launches, drop_launches)
    torch.cuda.empty_cache()
    lap("[6] T2/drop")

    log(f"[7] pretraining: BERT-base at {L_SEQ} tokens through "
        f"Executor.run [{card}]")
    bert_runs, bert_launches = drive_bert(card, device)
    training += bert_runs
    lap("[7]")

    log(f"[8] training: ResNet-50 through Executor.run, kernel #8 on its "
        f"conv3 sites, the conv1x1 probe [{card}]")
    resnet_runs, resnet_launches = drive_resnet(card, device)
    training += resnet_runs
    lap("[8]")

    log(f"[9] training: bench.py's image legs through Executor.run "
        f"({', '.join(IMAGE_LEGS)}), then the book's main programs "
        f"(B/book) [{card}]")
    training += drive_images(card, device, lap)

    log(f"[10] the recurrent family: the stacked LSTM (SL1, SL2) and the "
        f"GRU translator (MT1, MT2, MT/decode) [{card}]")
    rnn_runs, rnn_launches = drive_rnn(card, device, lap)
    training += rnn_runs

    log(f"[11] serving a saved model: bench.py's infer leg (I/infer: "
        f"{', '.join(INFER_PUBLISHED)}) and Predictor.generate (I/gen) "
        f"[{card}]")
    saved_runs, saved_launches = drive_saved_models(card, lap)
    phases += saved_runs

    log(f"[12] the serving front end: transformer-base over loopback TCP "
        f"(F/rpc), the telemetry tax (F/tax), the Poisson sweep (F/sweep) "
        f"and the overload A/B (F/overload) [{card}]")
    s_step_ms = next(p for p in phases
                     if p.get("phase") == "S")["decode_step_ms"]
    front_runs, front_launches = drive_front_end(card, s_step_ms, lap)
    phases += front_runs

    log(f"[13] the serving fleet: transformer-base replicas behind a "
        f"FleetRouter, in process (F/fleet/inproc) and as replica processes "
        f"(F/fleet: weak scaling, a rolling deploy, kill -9), and the "
        f"disaggregated prefill/decode A/B with the two-tier fleet "
        f"(F/disagg) [{card}]")
    fleet_runs, fleet_launches = drive_fleet(card, lap)
    phases += fleet_runs

    log(f"[14] the int8 tier and the optimizer tail: the int8 ops against "
        f"their plain versions (Q/ops), bench.py's int8 infer rows (I/int8: "
        f"{', '.join(INT8_INFER)}), its serving_int8 leg (S/int8), the int8 "
        f"draft (V/int8), quantization-aware training (Q/qat) and the "
        f"optimizer tail (O/tail) [{card}]")
    v_trunc = next((p for p in phases if p.get("phase") == "V/trunc"), None)
    int8_runs, int8_launches = drive_int8(card, device, v_trunc, lap)
    phases += int8_runs

    log(f"[15] BERT-base pretraining as bench.py runs it: its seven legs "
        f"({', '.join(BERT_LEGS)}: B/head), the memory options on T2's and "
        f"the BERT headline's step (fused_head, RecomputeOptimizer: B/mem), "
        f"and clipping, L1 decay and learning-rate schedules (O/clip) "
        f"[{card}]")
    tail_runs, tail_launches = drive_bert_tail(card, device, lap)
    training += tail_runs

    log(f"[16] the sparse tier and the checkpoint manager: CTR DeepFM at "
        f"bench.py's ctr_deepfm config through SparseTrainStep, sync and "
        f"pipelined (CTR), resumed from a CheckpointManager save "
        f"(CTR/resume), over shard-server processes with a kill -9 "
        f"(CTR/remote), bench.py's reshard leg (SP/reshard) and ckpt leg "
        f"(CK/resnet) [{card}]")
    training += drive_sparse(card, lap)

    log(f"[17] the dense op tails: every new op type of the slice on the "
        f"card against the port's CPU path, jit against interpret (X/ops), "
        f"a primitive-level transformer-base encoder trained from layers "
        f"and nets (X/attn), and the metric ops against metrics.py "
        f"(X/metrics) [{card}]")
    training += drive_op_tails(card, device, lap)

    log(f"[18] control flow and the sequence family: the book's machine "
        f"translation chapter trained and beam-decoded (CF/mt), a "
        f"cached-attention LM in a BeamSearchDecoder (CF/beam_lm), while, "
        f"IfElse and conditional_block (CF/while), the sequence ops "
        f"(SEQ/ops) [{card}]")
    cf_runs, cf_launches = drive_control_flow(card, device, lap)
    training += cf_runs

    log(f"[19] the recurrent tail and the sequence losses: the reference "
        f"label-semantic-roles chapter trained at its widths (SRL/train) "
        f"and decoded, in process and by a Predictor (SRL/decode), the four "
        f"RNN fusions of the InferenceTranspiler (RNN/fuse), the slice's 17 "
        f"op types (SEQ/tail) [{card}]")
    training += drive_recurrent_tail(card, device, lap)

    log(f"[20] the mixture-of-experts tier: bench.py's moe leg and its "
        f"dense twin, served (MoE/bench), a resumed MoE checkpoint "
        f"(MoE/ckpt), transformer-base with every FFN a mixture of "
        f"{MOE_EXPERTS} experts at T2's settings (MoE/base) and its decode "
        f"through the Scheduler on both pools (MoE/serve) [{card}]")
    t2 = next((r for r in training if r.get("phase") == "T2"), {})
    moe_runs, moe_launches = drive_moe(card, device, t2, lap)
    training += moe_runs

    log(f"[21] multi-device training: transformer-base on a "
        f"{MESH_RANKS}-rank gloo world on this card, 3 of dryrun_multichip's "
        f"legs (M/dp_tp, M/ring, M/zero1) against the single-process run, "
        f"and a direct ring_attention call (M/ring/check) [{card}]")
    mesh_runs, mesh_launches = phase_mesh(card, device)
    training += mesh_runs
    lap("[21]")
    for more in (counts, train_launches, bert_launches, resnet_launches,
                 rnn_launches, saved_launches, front_launches,
                 fleet_launches, int8_launches, tail_launches, cf_launches,
                 moe_launches, mesh_launches):
        for k, n in more.items():
            launches[k] = launches.get(k, 0) + n
    never = [k for k in KERNELS if not launches.get(k)]
    if never:
        raise AssertionError(f"kernels {never} never launched on a path")

    log(f"  all phases took {laps[-1] - laps[0]:.1f} s wall")
    log("results")
    log(json.dumps({"phases": phases}))
    log(json.dumps({"training": training}))
    if DIVERGED:
        log(f"FAILED: {len(DIVERGED)} served requests differ from the "
            f"sequential Generator: {json.dumps(DIVERGED)}")
        return 1
    kernels = []
    for name, meta in KERNELS.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = mine[0]   # the shape the main path launches most
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_us": head["bound_ms"] * 1e3,
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"],
            "cases": [{k: c[k] for k in ("case", "shape", "max_abs_err", "ms",
                                         "device_ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by", "flop", "bytes",
                                         "tflops")}
                      for c in mine],
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
