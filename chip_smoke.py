#!/usr/bin/env python3
"""Drive the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA card.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each printing one JSON line:

* ``device``: ``torch.cuda`` must see a card (else the script exits 1 and
  prints no result); nvidia-smi's name and power limit.
* ``build``: compiles every ``deepspeed_tpu_torch/csrc/*.cu`` with nvcc, one
  process per source, all started together; reports ptxas's registers and
  spill bytes per kernel, and reads ``cuobjdump -sass`` of the built
  libraries: each wgmma kernel (B1, B2, B3, B5, B6, B7) must hold HGMMA (wgmma) and
  UTMALDG (TMA loads) instructions, or the script fails.
* ``kernel``: holds each kernel against its plain PyTorch version on the
  card, at the 1.3B shapes and at edge cases, and times the kernel, the
  plain version and one PyTorch library call that computes the same
  function, each by the card's own time (``device_ms``; the CUDA-event mean
  over back-to-back calls stays beside it as ``event_ms``): B1 (flash
  forward; the library call is SDPA under the fastest of its flash, cuDNN
  and efficient backends), B2/B3 (flash backward: dq, dk/dv; also the
  full autograd gradient, bit-reproducibility and segment isolation), B4
  (fused AdamW over GPT-2 1.3B's parameter shapes, 3 steps) and B5/B6/B7
  (block-sparse forward, dq, dk/dv: every sparsity family, blocks 16-128, D
  64 and 128, bf16 and f32, causal and not, per-head layouts, rows that see
  no key, layouts with several long rows (also under causal),
  and BERT-Large's BigBird shape, where they are timed against SDPA under
  the expanded mask, B5 and B6 also with their query blocks in row order
  and B7 with its key blocks in column order instead of longest first; the
  forward and the backward must be bit-reproducible). Then the sweep behind
  ``use_flash_attention="auto"`` (``flash_auto_sweep``): the flash kernels
  (B1, and B1 + B2 + B3 with the backward) against the model's einsum path,
  causal bf16, D 64 and 128, T 128-8192 at 8192 tokens a call, by device
  time, with the selector's constants it implies beside the model's.
* ``serve``: GPT-2 1.3B at full width and depth (random weights, seed 0)
  through ``init_inference``: ``forward`` on [4, 1024] ids through the flash
  kernel, checked against the einsum path on the same weights, then
  ``generate`` of 32 greedy tokens for 4 ragged prompts. The kernels' launch
  counts are set to 0 just before this phase and read just after it. Then
  the decode graphs (``decode_chunk`` 32: runs of 16, 8, 4, 2 and 1 steps,
  one CUDA graph each) against eager decode (every step uncaptured, chunk
  1), greedy and sampled from the same generator seed, over the warm-up,
  capturing and replaying calls: the tokens must be identical; decode ms
  per token from the graphs and from eager decode.
* ``profile``: the card's time by kernel in one traced forward and one
  traced generate (torch.profiler), and in ``train`` and ``sparse_train``
  one traced step, a graph replay: its card-busy share, and the count of
  each kernel in the trace, which must equal the launches per step.
* ``small``: a small fp32 GPT on the card, whose greedy ``generate`` must
  equal an argmax rollout of the full forward, token for token, and whose
  decode graphs must give eager decode's tokens (as in ``serve``).
* ``train`` (the training slice's main path): GPT-2 1.3B at full width and
  depth through ``initialize`` with ``benchmarks/gpt_pretrain.py``'s
  config as written (bf16, full remat, ``use_flash_attention="auto"``,
  which routes T 1024 to the flash kernels, FusedAdam on B4, micro batch 4
  x 1024):
  one step on the einsum path from the same seed's weights, checked against
  the flash step; then 12 steps through ``train_batch`` on one repeated
  batch, the first 2 the capture's warm-up and the other 10 replays of the
  step's CUDA graph, against 12 steps of a second engine from the same seed
  whose step function is called uncaptured (the engines run one after the
  other): losses, grad norms and final parameters must be identical, the
  loss must fall, and each step must launch B1 48, B2 24, B3 24 and B4 1
  times (counts set to 0 just before the 12 captured steps and read just
  after; a replay counts the launches its capture saw). Median step ms of
  both runs.
* ``data`` (the data slice's main path): GPT-2 1.3B as in ``train`` with a
  ``data_pipeline`` block (``DATA_PIPELINE``: seq_length 1024, packing,
  prefetch depth 2) over a corpus of 3000 documents made from seed 0
  (lengths log-uniform in 32-1024 tokens, three longer, Zipf tokens), fed
  through ``initialize(..., training_data=docs)``: 12 captured steps with
  prefetch (counts set to 0 just before them: B1 48, B2 24, B3 24, B4 1
  per step, B1-B3 all in their segment variant, every batch with a row of
  several documents, the loss falling) against 12 uncaptured ones and 12
  captured ones without prefetch, bit for bit (losses, grad norms, final
  parameters); the prefetcher's counters and the step medians. One packed
  batch through the flash kernels and through the einsum path with the
  segment mask (``PACKED_LOSS_REL_TOL``, ``PACKED_GNORM_REL_TOL``), and the
  flash path's per-token losses after one document's tokens changed: every
  other document's bit-identical. The curriculum (``DATA_CURRICULUM``,
  fixed_linear 256 to 1024 in steps of 256 over 12 steps, packing to the
  difficulty, prefetch on, each copy held until a capture is under way):
  as many graphs as lengths, captured equal to eager bit for bit, the
  launches at every length, the peak memory. A small GPT saved after 4
  steps and resumed in a fresh engine: the next batches token-identical
  and the losses bit-identical. B1-B3 at the packed batch's segment ids
  against no segments, in turns, by device time.
* ``checkpoint`` (the checkpoint slice's main path): GPT-2 1.3B as in
  ``train``, 4 steps (2 warm-up, the capture, 1 replay), then
  ``save_checkpoint`` with the synchronous engine (a 13.1 GB tag under
  ``build/``, after a check of the free disk), 3 more steps, then
  ``load_checkpoint`` into the same engine: no step is captured again (the
  same graphs, 3 more replays each), the 3 steps again must be
  bit-identical (losses, grad norms, final parameters) and launch B1 48,
  B2 24, B3 24 and B4 1 times each; a second engine from another seed
  loads the tag and its 3 steps must be bit-identical too; then
  ``init_inference(checkpoint=tag_dir)`` must give the logits on [4, 1024]
  of an engine built from the saving engine's ``state_dict``, bit for bit.
  Save, verification and load seconds, GB/s, host peak RSS, and the step
  ms after the load against before it. Then, on small GPTs: the async
  engine (a step between ``save`` and ``wait`` must not reach the file),
  ``keep_n`` 2 over 4 saves, a flipped byte (load falls back to the
  previous tag), a corrupt tag with no fallback (load raises), ``set_lr``
  under replay (lr 0 freezes the parameters, the next lr moves them, no
  capture), and LAMB, Adagrad and SGD captured against uncaptured.
* ``sparse_train`` (the block-sparse slice's main path): BERT-Large at full
  width and depth, max positions 4096, through ``initialize`` with
  ``benchmarks/sparse_attention_bench.py``'s config and its BigBird block
  with ``"kernel": "pallas"`` (bf16, full remat, FusedAdam on B4, micro
  batch 1 x 4096, no attention mask): one step on each of the gather and
  dense implementations from the same weights must agree with the kernels'
  step in loss, global gradient norm and the attention ``qkv`` weights'
  gradients; then 12 captured steps against 12 uncaptured ones, as in
  ``train``: identical, the loss must fall, and each step must launch B5
  48, B6 24, B7 24 and B4 1 times; then a traced replay. The gather and
  dense steps are timed too (median of 3 after the first; captured too).
* ``small_capture``: captured against uncaptured steps of small GPTs:
  fp16 with a loss scale of 2^26, whose gradients overflow past the
  capture's warm-up (each skipped step must halve the scale and keep the
  optimizer's count, and replays must both skip and update), and bf16 with
  gradient accumulation 2 (the micro-step and apply graphs); identical
  losses, grad norms, scales, counts and parameters, exact launches.
* ``small_train``: a small fp32 GPT trained 3 steps on the card (B1-B4) and
  on the CPU (plain versions) from the same weights and batches; losses and
  parameters must agree.
* ``zero`` (the data-parallel slice's main path, and ZeRO stage 3's):
  world = the visible cards, in process on a one-rank NCCL group at world
  1, one process per card above (``--zero-rank``, a file rendezvous
  under ``build/``); ``nvidia-smi topo -m`` once, the world on every line. Rank 0 first runs
  a group-less engine on one card at gas = world over the same global
  batches (the reference). Then every rank joins the group and trains
  GPT-2 1.3B (micro 4 x 1024 per rank, ``GPT_PRETRAIN_CONFIG`` at ZeRO
  stages 0, 1, 2 and 3; stage 3 keeps a shard of every leaf of at least
  100,000 elements, gathers each block's as the block runs and again in the
  remat recompute, and reduce-scatters each block's gradient in the
  backward, all in the captured step) for 12 captured steps against 12
  uncaptured ones:
  bit-identical on each rank, the same loss and parameters on every rank,
  B1 48 / B2 24 / B3 24 / B4 1 launches per step (counts set to 0 before
  each stage's captured steps), the loss falling, losses, parameter
  updates and each step's grad norm within ``ZERO_LOSS_REL_TOL`` /
  ``ZERO_UPDATE_REL_L2`` / ``ZERO_GRAD_NORM_FIRST_REL_TOL`` (the first
  step) and ``ZERO_GRAD_NORM_REL_TOL`` of the reference. At world > 1 rank
  0 also runs the control, the group-less engine without the last rank's
  rows, which must break at least one of those bounds. Then the step
  median, peak memory per rank against the predicted state bytes, a
  traced replay with the NCCL kernels' card time and bus bandwidth, a bare
  2.63 GB all-reduce as the bandwidth's yardstick, the comms logger's
  counters, and B4 over one rank's flat shard, held bit for bit against
  its plain version (and its skip flag) and timed. At world >= 4 (at
  fewer cards one line says why not): GPT-2 6.7B, whose state no one card
  holds, at micro 4 x 1024 per rank, 12 captured steps at stage 2, then 12
  captured steps at stage 3 against 12 uncaptured ones (bit-identical),
  B1 64 / B2 32 / B3 32 / B4 1 launches per step, stage 3's losses and
  updates within the 1.3B bounds of stage 2's, stage 3's peak memory below
  stage 2's, step ms, peak memory against the predicted state and a traced
  replay's NCCL time for each. The gradient exchanges (``grad_exchange``,
  the slice's main path): first the card's ``quantized_all_reduce`` and
  ``compressed_allreduce`` on one 4 MB tensor against their single-process
  simulation on the same card (every rank's input gathered, quantized or
  signed as its rank does it, summed in rank order: bit-identical, or
  within one step with the equal share printed), timed; small bf16 GPTs
  under 1-bit LAMB, 0/1 Adam and (at an even world above 1) the
  hierarchical exchange over 2 slices, captured against eager; then
  GPT-2 1.3B at gas 2 and stage 0 under (a) the deferred bucketed exchange
  (4 MB buckets) at a bf16 wire (the main path; its launches are the
  path's) and at an f32 wire, (b) int8 in 4 MB buckets and (c) 1-bit Adam
  with freeze_step 4, each 12 captured steps against 12 uncaptured ones
  (bit-identical, error feedback included), B1 96 / B2 48 / B3 48 / B4 1
  (0 under 1-bit) launches per step, the loss falling, every rank's
  parameters equal; (a) at f32 against the stage-0 engine with an f32
  exchange (the first step's update within ``GX_FP32_UPDATE_REL_L2``, its
  grad norm and the 12 steps within the zero bounds), (a) at bf16 and
  (b) against (a) at f32 in the loss (``GX_LOSS_REL_TOL``), which the
  control (the group-less engine without the last rank's rows) must break
  at world > 1, and (c), which ignores the clip and changes its rule at
  the freeze step, to a loss that falls after it; per mode the step and eager ms, a traced replay's NCCL ms by kind,
  the comms logger's wire bytes per step against the prediction, and the
  peak memory against the state. (At world 1 the JAX engine, and so the
  port, runs (a) as the plain stage-0 step: no dp axis to defer over.)
  Small GPTs: stages 2 and 3 at gas 2
  captured against eager; fp16 at stage 1 from a
  growing loss scale (every rank skips each step on which any rank's
  shard overflowed; at world > 1 some overflow must be local to some
  shards); a stage-1 tag saved at this world, resumed at this world
  (bit-identical), at stages 2 and 3 and on one card with no group (within
  the CPU tests' tolerances). The data path at stage 1 on small GPTs
  (micro 2 x 256 per rank, prefetch on): under ``shard: "process"`` the
  ranks' documents are disjoint and each rank's the prefix of its own
  stride, under ``"none"`` each rank's rows its slice of the one-rank
  pipeline's batch; a tag saved after 2 steps resumes at this world with
  every rank's next batches and losses identical, and on one card without
  a group with the stream re-strided from rank 0's state. BERT-Large under
  BigBird at [1, 4096] per rank (``BERT_SPARSE_CONFIG``, dropout 0) at
  stage 3 (25 units: each of ``encoder.layer`` and the outer unit): 12
  captured steps against 12 uncaptured ones, B5 48 / B6 24 / B7 24 / B4 1
  per step, each step's loss and grad norm within the zero bounds and the
  first step's update within ``BERT_FIRST_UPDATE_REL_L2`` of a group-less
  engine at gas = world that rank 0 runs first (every row with the same
  count of labels); at world >= 4 also at stage 0 under the deferred
  f32, int8 (4 MB buckets) and 1-bit Adam (freeze_step 4, the exact grad
  norm on) exchanges: int8 and 1-bit's warm-up against the deferred f32
  run in loss and grad norm, the losses falling.

* ``mistral`` (the LLaMA-shaped trunk's main path): Mistral-7B-v0.1's
  config (``MISTRAL_7B``: RMSNorm, gated SiLU MLP, no biases, rotary, 32
  query heads over 8 KV heads, an untied head; ``n_positions`` cut to its
  4096-token sliding window), random weights from seed 0, bf16. Serving
  at ``MISTRAL_SERVE_LAYERS`` (8) of its 32 layers (the ``serving`` phase
  serves all 32) through ``init_inference``: ``forward`` on [2, 4096]
  through B1 against the einsum path (relative L2 of the logits,
  ``MISTRAL_LOGITS_REL_L2``), ``generate(32)`` for 4 left-padded prompts of
  37-512 tokens with the decode graphs against eager decode (tokens, and
  the logits of a captured 8-step decode run bit for bit), cached decode
  against the full forward of the same sequences; forward, prefill and
  decode times, peak memory, and the card's time by kernel in one traced
  forward and one traced 8-token generate. Training at 8 layers (the
  depth cut) through
  ``initialize`` with ``GPT_PRETRAIN_CONFIG`` at micro [2, 4096]: one
  einsum step against the flash step, 12 captured steps against 12
  uncaptured ones (identical), the loss falling, B1 16 / B2 8 / B3 8 / B4
  1 launches per step and no segment variant; step ms, tokens/s, model
  TFLOP/s. One packed batch of the data phase's corpus at vocab 32000,
  [2, 4096]: B1-B3's segment variant against einsum, per-document
  isolation. B1-B3 at [2, 4096, 32, 128] (k and v repeated from 8 heads)
  against their plain versions on batch 1, heads 0-7, and timed against
  their bounds, the plain versions and SDPA's backends (cuDNN among them).
  The serving and training checks are ``serve_lm`` and ``lm_train``,
  which the next two phases share.
* ``neox`` (the parallel residual, the embedding LayerNorm and ALiBi):
  Pythia-6.9B's config (``PYTHIA_6P9B``: parallel residual, rotary on 25%
  of each head, exact GELU, biases, an untied head), served at
  ``PYTHIA_SERVE_LAYERS`` (16) of its 32 layers as ``mistral`` serves
  (``forward`` [2, 2048] through B1 against einsum, decode graphs against
  eager, cached decode against the forward)
  and trained at 8 layers at micro [4, 2048] (one einsum step against the
  flash step, 12 captured steps against 12 uncaptured ones, the loss
  falling, B1 16 / B2 8 / B3 8 / B4 1 per step, a traced replay); then
  BLOOM-7b1's (``BLOOM_7B1``: ALiBi, the embedding LayerNorm, a tied head,
  vocab 250880) served at ``BLOOM_SERVE_LAYERS`` (15) of its 30 layers,
  its ``forward`` [1, 2048] with
  ``use_flash_attention=True`` launching B1 0 times (JAX's gate: ALiBi
  takes the einsum path), decode against eager and against the forward.
* ``moe`` (mixture of experts): Mixtral-8x7B-v0.1's config
  (``MIXTRAL_8X7B``: the Mistral trunk, 8 gated-SiLU experts, top-2,
  capacity factors 2.0 and 4.0, rotary theta 1e6; ``n_positions`` cut to
  4096) served at ``MIXTRAL_SERVE_LAYERS`` (8) layers (``forward`` [1,
  4096] through B1 against
  einsum, each layer's tokens per expert, the first layer's spread over
  every expert; decode graphs against eager; cached decode against the
  forward) and trained at 2 layers at micro [2, 4096] with the engine's
  gating noise (captured against eager bit for bit, two more replays
  drawing different noise, the loss falling, B1 4 / B2 2 / B3 2 / B4 2
  per step: B4 once for the bf16 weights and once for the f32 gates; the
  active and the executed FLOPs); the index dispatch/combine against the
  dense one-hot products at the training shape (dispatch bit for bit, the
  f32 combine within ``MOE_COMBINE_REL_L2``), each timed with its
  backward, and their share of the step; a small top-1 MoE GPT (RSample
  and RTS) saved to a tag with one file per expert and kind and resumed
  in a fresh engine bit for bit (losses, noise, parameters), and trained
  at ZeRO stages 0-2 on a one-rank NCCL group, captured against eager and
  against the group-less engine.

* ``train_options`` (the GPT training options of ROADMAP A.6; ``--only
  train_options`` runs the sweep first): GPT-2 1.3B's widths
  (``gpt_pretrain.py``'s config, [4, 1024]) at ``OPTIONS_LAYERS`` (12) of
  its 24 layers under each ``remat_policy`` (``full``, ``selective``,
  ``save_nothing_but_flash``, ``save_dots``): 12 captured steps against 12
  uncaptured ones (bit for bit), B1 24 / 12 / 12 / 24 per step (B2 12, B3
  12, B4 1), and every policy's losses, grad norms and final parameters
  bit for bit equal to ``full``'s; the step medians and peaks. At dropout
  0.1 (B1-B3 0: the einsum path, JAX's gate): captured against eager, two
  replays at lr 0 giving different losses, each of the 37 sites' kept
  share within 6 binomial deviations of 0.9, the same 12 steps without
  remat bit for bit, and a small GPT's tag resuming the mask stream bit
  for bit. ``stochastic_mode`` under ``progressive_layer_drop`` (theta
  0.5, gamma 0.001; B1 24 / B2 12 / B3 12 / B4 1): captured against
  eager, the device theta against the host schedule before every step, and
  a small GPT's per-layer keep counts over 256 steps against the schedule.
  BLOOM-7b1 at 8 layers, micro [6, 2048] (6.17e9 bytes of logits: the
  fused head by ``"auto"``, its calls counted; 0 B1-B3), captured against
  eager, the loss falling; then at [2, 2048] the fused head against the
  unfused one (loss, gradients, peaks). Mistral-7B at 8 layers, [2, 4096],
  ``attention_chunk=1024`` (0 B1-B3) against the flash run (first loss and
  grad norm, step medians), and its 32-layer ``forward`` [1, 4096] chunked
  against flash.
* ``sparse_gpt`` (the GPT block-sparse route and the ring KV cache):
  Mistral-7B's sliding window at ``n_positions`` 32768 on B5-B7, served at
  ``SPARSE_GPT_SERVE_LAYERS`` (8) of its 32 layers from the ring cache
  (the ``serving`` phase serves all 32 from the int8 ring)
  and trained at 8 on [1, 16384] (``--only sparse_gpt``).
* ``bert_options`` (BERT breadth, ROADMAP A.7; ``--only bert_options``):
  BERT-Large at full width and depth (24 layers) under BigBird (block 128,
  ``"pallas"``: B5-B7) at [1, 4096] with its published dropout 0.1, under
  each ``remat_policy``: 12 captured steps against 12 uncaptured ones (bit
  for bit), B5 48 / B6 24 / B7 24 / B4 1 per step under every policy (no
  policy keeps B5's output), the loss falling, every policy's losses,
  grad norms and parameters bit for bit ``full``'s (the same masks), two
  replays at lr 0 drawing different masks, step medians and activation
  GB by policy; the kernels' first loss and grad norm against the
  ``"gather"`` route's at the same masks, and a dropout-0 engine's loss
  unlike the dropout-0.1 one; stochastic depth under the DeepSpeed PLD
  tutorial's BERT settings (theta 0.5, gamma 0.001) with dropout 0.1:
  captured against eager, the device theta against the host schedule
  before every step, the layers each eager step dropped against the
  schedule's expectation; a dense BERT-Large at [8, 512] with dropout 0.1
  (the einsum path, B4 only) captured against eager.
* ``serving`` (serving breadth, ROADMAP A.8; ``--only serving``):
  Mistral-7B-v0.1 at all 32 layers under ``sparse_gpt``'s window with one
  slack block, int8 weights and int8 KV cache (``init_inference(dtype=
  "int8", config={"kv_cache": "int8"})``), through the continuous-batching
  scheduler (8 lanes, bucket 128, a ``PrefixCache``): 24 requests from
  seed 0 (prompts of 64-3000 tokens, half sharing a 1024-token prefix,
  16-48 new tokens, an EOS on every third, 4 submitted from a stream
  callback while ``run`` goes), held against each request's solo
  ``generate`` on the same engine; the first wave through the graphs and
  through the eager twin (tokens and the lanes' cache bit for bit); the
  shared-prefix requests without the prefix cache (hits against cold
  admissions); ``kv_cache_stats``' bytes against ``memory_allocated``
  around the lanes' allocation, int8 and bf16; the 8-lane decode step,
  int8 against bf16 weights, timed and traced. Streams may part only at a
  near-tie: the reference's top-1 minus top-2 gap under ``gap_bound``.
  Then GPT-2 1.3B: the ``forward`` graph against eager ``forward`` at [4,
  1024] (bit for bit, B1 24 per replay; counts set to 0 just before the
  replay), the prefill graphs against eager prefill per bucket (logits and
  cache bit for bit, TTFT), speculative decoding (k 4) with a
  GPT-2-125M-shaped draft and with the target's own weights against the
  scheduler without a draft (one ``serve.spec_accept`` event per
  speculative step), and int8 against bf16 decode at 125M and 1.3B. The
  scheduler run's counts are set to 0 just before it (no kernel runs on the
  cache path). Its ``disagg`` part, on the same Mistral-7B engine:
  ``DisaggServer`` with one ``PrefillWorker`` over 12 of the requests, all
  submitted before ``run``, against the co-located scheduler on the same
  requests (tokens bit for bit), one ``serve.kv_transfer`` per request,
  each hand-off's bytes ``lane_kv_bytes``' resident bytes, int8 against
  bf16, and the hand-off's copy timed.
* ``frontdoor`` (the serving front door, ROADMAP A.8; ``--only
  frontdoor``): GPT-2 1.3B at full width and depth, bf16, dense cache.
  ``build_serving`` (``FRONTDOOR_SERVING``) against a scheduler built by
  hand from the same parts (bit for bit), and an unknown key refused; 24
  requests from seed 0 (prompts of 64-960 tokens, half sharing a 512-token
  prefix, 32 new tokens each) through it in this process are the
  reference. A burst (the first wave, then 20 at once from a stream
  callback) without admission, then with an SLO of half the first wave's
  p95 TTFT: the controller enters shedding and, after its samples age
  out, leaves it; typed rejections, ``serve.shed`` events and reject
  callbacks agree. ``GracefulDrain`` and a SIGTERM from a stream callback:
  admission closes, the lanes finish, the queue's replay specs complete on
  a fresh scheduler. The bus's counts against the schedulers' counters.
  Then ``FRONTDOOR_REPLICAS`` replica processes (``ReplicaFleet``, spawned
  at the phase's start, built while the parent serves) serve the trace
  behind a ``FleetCoordinator``: a warm-up run, the baseline, and the
  chaos run, which SIGKILLs the most-loaded replica after 6 delivered
  tokens: no request lost, one ``serve.failover`` per migrated request,
  one ``serve.replica_down``, p95 TTFT with failover and without (the
  counterfactual), each replay's seconds. Every stream is held against the
  reference and may part only at a near-tie (``gap_bound``); the parent's
  and each replica's launch counts stay 0 (the cache path runs no
  kernel).

Then the kernels line, nvidia-smi's line and, last, ``{"ok": true, ...}``.
A failed check raises, and the script exits nonzero. It imports neither jax
nor ``deepspeed_tpu``.

``python3 chip_smoke.py --only zero`` runs only the ``device``, ``build``
and ``zero`` phases, then nvidia-smi's line and the ``{"ok": true, ...}``
line (on a machine with four cards, the four-card measurement);
``--only data`` the same with the ``data`` phase, ``--only mistral`` with
the ``mistral`` phase, ``--only neox`` with ``neox``, ``--only moe``
with ``moe``, ``--only train_options`` with the sweep and
``train_options``, ``--only sparse_gpt`` with the window kernel case, its
timing and ``sparse_gpt``, ``--only bert_options`` with
``bert_options``, ``--only serving`` with ``serving``, and ``--only
frontdoor`` with ``frontdoor``. Every phase
line carries ``seconds`` (since its phase began), and the full run prints
each phase's wall seconds (``phase_seconds``) before the kernels line.

``python3 chip_smoke.py --against DIR`` runs only the A/B of the backward
kernels and of the fused AdamW: DIR holds another checkout's
``deepspeed_tpu_torch/`` (for instance ``git archive <commit>
deepspeed_tpu_torch | tar -x -C build/parent``), whose kernels are built
beside this tree's; B2 and B3 (at GPT-2 1.3B's training shape, and at D 64
under segments), B6 and B7 (at BERT-Large's BigBird shape) and B4 (over
GPT-2 1.3B's parameters) of both builds run on the same tensors in turns
(other, this, this, other), timed by device time. B2's, B3's and B4's
outputs must be bit-identical across the builds, B6's and B7's within
``GRAD_REL_TOL`` of the plain backward; one JSON line per kernel and shape,
then nvidia-smi's line.
"""

import dataclasses
import functools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

# max-abs error allowed against the plain version, per input dtype: bf16 keeps
# ~3 significant digits and P is rounded to bf16 before P@V, so o may differ
# by a few 1e-3 on O(1) values; lse is an f32 sum on both sides
TOLERANCE = {"bfloat16": {"o": 2e-2, "lse": 1e-3},
             "float16": {"o": 5e-3, "lse": 1e-3},
             "float32": {"o": 1e-4, "lse": 1e-4}}

# flash (f32 scores) against einsum (bf16 scores) on the same 1.3B weights:
# the two paths round differently at every layer, so logits differ by bf16
# noise; top-1 agreement is held to 0.9 because random weights leave many
# near-ties among 50257 logits
SERVE_TOP1_MIN = 0.9
SERVE_MAX_ABS_LOGIT_DIFF = 1.0

# B2/B3 against the plain backward, as max-abs error over the largest
# reference gradient: with 16-bit inputs P and dS are rounded to the input
# dtype before the second products (as in the TPU kernels), so errors reach
# a few ulps of the largest entries (bf16 ulp 2^-8, f16 2^-11); f32 runs in
# f32 FMA and differs only in the order of sums
GRAD_REL_TOL = {"bfloat16": 2e-2, "float16": 5e-3, "float32": 1e-5}
# B5 against its plain version, as the largest relative L2 error of one row
# of o (a query and head, over D) among the rows that see a key: a row that
# attends thousands of keys has |o| near sqrt(e / n), so a max-abs limit on
# O(1) values may not see a tile of P@V dropped or read from the wrong block
# (a third or more of the row); bf16 rounds o on both sides and P before
# P@V, so a row differs by up to about 5e-3 (f32: about 1e-6)
O_ROW_REL_TOL = {"bfloat16": 1e-2, "float16": 2e-3, "float32": 1e-5}
# B4 against its plain version: each op is one IEEE f32 rounding on both
# sides, in the same order, so p, m and v must be bit-identical. The
# parameters are drawn at GPT-2's init scale (std 0.02), where one bf16 ulp
# is at most 2^-13 and Adam's first steps (about lr = 2e-4 each) move p; at
# least this share of p's entries must have moved, so that the comparison
# sees the update and not only the rounding back to bf16
ADAMW_MIN_MOVED = 0.9

# GPT-2 1.3B train step, flash against einsum on the same weights and batch
# (bf16): the paths round scores and probabilities at different points, so
# the loss (about ln 50257 = 10.8) agrees to 1e-3 relative and the global
# grad norm (bf16 gradients, each rounded at 2^-8) to 1e-2 relative
TRAIN_LOSS_REL_TOL = 1e-3
TRAIN_GNORM_REL_TOL = 1e-2
# one batch repeated 10 times is memorized: the loss must fall by at least
# 1 nat from the first step to the last
TRAIN_MIN_LOSS_DROP = 1.0
# small f32 model, card against CPU: losses to 1e-5 relative. Parameters
# are compared through their updates (final minus initial weights): Adam
# divides by sqrt(v), so an entry whose gradient is near zero turns f32
# rounding differences into update differences of up to lr; a max-abs bound
# would measure those few entries, so the updates are held to 1e-3 in
# relative L2 norm (the max-abs error is reported beside it). The key part
# of the c_attn bias is left out of the comparison: its gradient is zero in
# exact arithmetic (softmax ignores a per-row shift), so both sides hold only
# rounding noise there, which Adam normalizes to steps of +-lr
SMALL_LR = 1e-3
SMALL_LOSS_REL_TOL = 1e-5
SMALL_UPDATE_REL_L2 = 1e-3


# when the running phase began (``start_phase``): every phase line that
# does not state its own ``seconds`` gets the seconds since then
_PHASE_STARTED = [None]


def start_phase():
    _PHASE_STARTED[0] = time.perf_counter()


def emit(obj):
    if (isinstance(obj, dict) and "phase" in obj and "seconds" not in obj
            and _PHASE_STARTED[0] is not None):
        obj = dict(obj, seconds=time.perf_counter() - _PHASE_STARTED[0])
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, iters=20, warmup=3):
    """Mean time of one call from CUDA events around ``iters`` back-to-back
    calls: the card's time plus any gap while the host launches the next
    call (the "event_ms" beside each kernel's device time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """The card's own time for one call of ``fn``, without the host's launch
    gaps: a spin kernel (``torch.cuda._sleep``) holds the card while the
    host enqueues ``iters`` calls, each followed by a CUDA event, so the
    card then runs them back to back and the events time each call.
    Returns ``{"ms": median per call, "min_ms", "max_ms", "mean_ms",
    "host_ahead"}``; ``host_ahead`` is False when the host had not finished
    enqueueing when the spin ended (a call that waits for the card, such as
    a copy from pageable memory), so the times may hold host gaps."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_s = min(2.0, 2 * iters * (time.perf_counter() - t0) + 2e-3)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 2)]
    ev[0].record()
    torch.cuda._sleep(int(hold_s * 2e9))  # >= hold_s at an SM clock <= 2 GHz
    ev[1].record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn()
        ev[i + 2].record()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[-1].synchronize()
    per_call = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(iters)]
    return {"ms": statistics.median(per_call), "min_ms": min(per_call),
            "max_ms": max(per_call), "mean_ms": sum(per_call) / iters,
            "host_ahead": host_ms < ev[0].elapsed_time(ev[1])}


def sdpa_yardstick(q, k, v, do, causal=True):
    """F.scaled_dot_product_attention forward and backward on contiguous
    [B, H, T, D] copies of q, k, v and the cotangent, under each backend that
    accepts the shape (flash, cuDNN, memory-efficient), by device time.
    Returns ``{backend: {"fwd": device_ms(...), "bwd": device_ms(...)}}``
    and the fastest backend's forward and backward."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2).contiguous().detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    found = {}
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION)):
        with sdpa_kernel(backend):
            try:
                out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
                torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
                torch.cuda.synchronize()
            except RuntimeError as e:  # the backend refuses this shape
                found[name] = {"unsupported": str(e).splitlines()[0][:120]}
                continue
            fwd = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            bwd = device_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True))
            found[name] = {"fwd": fwd, "bwd": bwd}
            del out
    ok = {n: r for n, r in found.items() if "fwd" in r}
    if not ok:
        raise AssertionError(f"no SDPA backend accepts the shape: {found}")
    best_fwd = min(ok, key=lambda n: ok[n]["fwd"]["ms"])
    best_bwd = min(ok, key=lambda n: ok[n]["bwd"]["ms"])
    return found, (best_fwd, ok[best_fwd]["fwd"]["ms"]), \
        (best_bwd, ok[best_bwd]["bwd"]["ms"])


def wall_ms(fn, reps=5):
    """Median host time of one call that ends in a device synchronise."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_device():
    import torch

    # the plain versions are the references: keep f32 matmuls in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


# the wgmma kernels of each library: their SASS must hold HGMMA (wgmma) and
# UTMALDG (TMA tile loads)
WGMMA_KERNELS = {"flash_attention_fwd": ("flash_fwd_wgmma_kernel",),
                 "flash_attention_bwd": ("bwd_dq_wgmma_kernel",
                                         "flash_bwd_dkv_wgmma_kernel"),
                 "block_sparse_attention": ("sparse_fwd_wgmma_kernel",
                                            "sparse_dq_wgmma_kernel",
                                            "sparse_dkv_wgmma_kernel")}


def ptxas_by_kernel(log):
    """ptxas -v lines per compiled function: registers and spill bytes."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def check_sass():
    """Reads ``cuobjdump -sass`` of each built library and requires HGMMA and
    UTMALDG in every instance of its wgmma kernels."""
    from deepspeed_tpu_torch.ops.cuda import build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    found = {}
    for lib, kernels in WGMMA_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, timeout=600,
                              check=True).stdout
        sections = re.split(r"\n\s*Function : ", sass)[1:]
        for name in kernels:
            bodies = [sec for sec in sections if name in sec.split("\n", 1)[0]]
            found[name] = {"instances": len(bodies),
                           "HGMMA": [sec.count("HGMMA") for sec in bodies],
                           "UTMALDG": [sec.count("UTMALDG") for sec in bodies]}
            if not bodies or not all(found[name]["HGMMA"]) or \
                    not all(found[name]["UTMALDG"]):
                emit({"phase": "sass", "kernels": found})
                raise AssertionError(f"{name}: no HGMMA or UTMALDG in its SASS")
    emit({"phase": "sass", "kernels": found})


def phase_build():
    from deepspeed_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    built = build.build()
    seconds = time.perf_counter() - t0
    emit({"phase": "build", "seconds": seconds, "sources": build.sources(),
          "compiled": {n: i["seconds"] for n, i in built.items()},
          "ptxas": {name: ptxas_by_kernel(info["log"])
                    for name, info in built.items()}})
    check_sass()


def _segments(b, t, gen, device):
    """Packed-batch segment ids: documents of random length, 1-based, with a
    0-padded tail."""
    import torch

    seg = torch.zeros((b, t), dtype=torch.int32)
    for row in range(b):
        pos, doc = 0, 1
        end = t - int(torch.randint(1, t // 8, (1,), generator=gen))
        while pos < end:
            n = int(torch.randint(8, t // 3, (1,), generator=gen))
            seg[row, pos:min(pos + n, end)] = doc
            pos, doc = pos + n, doc + 1
    return seg.to(device)


def attention_flops_bytes(b, t, h, d, causal, itemsize):
    """Operations and bytes one attention forward needs: 2 matmuls over the
    visible (query, key) pairs, q/k/v read once, o and lse written once."""
    pairs = b * (t * (t + 1) // 2 if causal else t * t)
    flops = 4 * pairs * h * d
    nbytes = 4 * b * t * h * d * itemsize + b * h * t * 4
    return flops, nbytes


def phase_kernel():
    """B1, the flash-attention forward, against its plain version."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # name, B, T, H, D, causal, dtype, packed segments
    cases = [
        ("serving_1p3b", 4, 1024, 16, 128, True, bf16, False),
        ("d64_full", 2, 512, 8, 64, False, bf16, False),
        ("ragged_t200", 2, 200, 16, 128, True, bf16, False),
        ("segments", 2, 384, 8, 128, True, bf16, True),
        ("fp16_ragged", 1, 333, 4, 128, True, f16, False),
        ("fp32", 1, 256, 4, 64, True, f32, False),
        ("fp32_full_segments", 1, 130, 2, 128, False, f32, True),
        ("long_t4096", 1, 4096, 16, 128, True, bf16, False),
        ("d64_causal_ragged", 2, 1000, 12, 64, True, bf16, False),
    ]
    serving = None
    for name, b, t, h, d, causal, dtype, packed in cases:  # B1
        # q, k, v as the model hands them over: views into one fused
        # [B, T, 3*H*D] projection, read through their strides
        qkv = torch.randn((b, t, 3 * h * d), generator=gen).to(dev, dtype)
        q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
        seg = _segments(b, t, gen, dev) if packed else None
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        segment_ids=seg)
        o_ref, lse_ref = fa.flash_attention_reference(
            q, k, v, causal=causal, segment_ids=seg)
        torch.cuda.synchronize()
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        tol = TOLERANCE[str(dtype).split(".")[-1]]
        line = {"phase": "kernel", "kernel": "flash_attention_fwd",
                "case": name, "shape": [b, t, h, d], "causal": causal,
                "dtype": str(dtype), "segments": packed,
                "o_max_abs_err": o_err, "lse_max_abs_err": lse_err,
                "tol": tol}
        if not (o_err <= tol["o"] and lse_err <= tol["lse"]):
            emit(line)
            raise AssertionError(f"flash_attention_fwd {name}: o err {o_err}, "
                                 f"lse err {lse_err} over {tol}")
        if packed:
            # another segment's keys and values must not touch a row:
            # perturb one document and require the others bit-identical
            target = seg[0, t // 2].item()
            hit = (seg == target)[:, :, None]
            qkv2 = qkv.clone()
            noise = torch.randn(qkv2[..., h * d:].shape, generator=gen)
            qkv2[..., h * d:] += 5 * noise.to(dev, dtype) * hit
            q2, k2, v2 = (x.view(b, t, h, d)
                          for x in qkv2.split(h * d, dim=-1))
            o2, _ = fa.flash_attention_fwd(q2, k2, v2, causal=causal,
                                           segment_ids=seg)
            keep = ~hit[..., 0]
            line["isolated_bit_exact"] = bool(torch.equal(o2[keep], o[keep]))
            if not line["isolated_bit_exact"]:
                emit(line)
                raise AssertionError(f"{name}: cross-segment leakage")
        emit(line)
        if name == "serving_1p3b":
            serving = (q, k, v, o_err, causal)

    q, k, v, o_err, causal = serving
    b, t, h, d = q.shape
    # the library yardstick for B1-B3: SDPA under each backend, fastest kept
    do = torch.randn((b, t, h, d), generator=gen).to(dev, q.dtype)
    sdpa, sdpa_fwd, sdpa_bwd = sdpa_yardstick(q, k, v, do, causal)
    dev_t = device_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
    ms = dev_t["ms"]
    plain_ms = device_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=causal), iters=5)["ms"]
    flops, nbytes = attention_flops_bytes(b, t, h, d, causal,
                                          q.element_size())
    bound_ms, bound_by = _bound(flops, nbytes, str(q.dtype).split(".")[-1])
    entry = {"name": "flash_attention_fwd", "route": "cuda", "variant": "wgmma",
             "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
             "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:53",
             "launches": None, "max_abs_err": o_err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": sdpa_fwd[1],
             "tflops_per_s": flops / ms / 1e9,
             "event_ms": cuda_ms(lambda: fa.flash_attention_fwd(
                 q, k, v, causal=causal))}
    emit({"phase": "kernel", "kernel": "flash_attention_fwd",
          "case": "serving_1p3b", "timing": entry, "device_time": dev_t,
          "library": f"F.scaled_dot_product_attention, {sdpa_fwd[0]} backend",
          "sdpa_by_backend": sdpa, "flops": flops, "bytes": nbytes,
          "tflops_per_s": flops / ms / 1e9})
    entries = ([entry] + check_flash_backward(cases, sdpa_bwd)
               + check_fused_adamw() + check_block_sparse())
    # B1-B3 at one rank's share of Mistral-7B's attention under tp 4 (the
    # parallel phase): 8 query heads reading 2 KV heads
    rank_shape = gqa_kernels("kernel", MISTRAL_MICRO, MISTRAL_SEQ,
                             MISTRAL_7B["n_head"] // PARALLEL_TP,
                             MISTRAL_7B["n_kv_head"] // PARALLEL_TP,
                             MISTRAL_7B["n_embd"] // MISTRAL_7B["n_head"])
    for e in entries:
        if e["name"] in rank_shape:
            e["tp4_rank_shape"] = {
                k: rank_shape[e["name"]][k]
                for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "library")}
    flash_auto_sweep()
    return entries


def _bound(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _rel_err(got, want):
    """Max-abs error of ``got`` over the largest entry of ``want``."""
    scale = max(float(want.float().abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / scale


def _row_rel_err(got, want):
    """Largest relative L2 error over the last axis, among the rows where
    ``want`` is not zero."""
    den = want.float().norm(dim=-1)
    err = (got.float() - want.float()).norm(dim=-1)
    seen = den > 0
    return float((err[seen] / den[seen]).max()) if bool(seen.any()) else 0.0


def check_flash_backward(cases, sdpa_bwd):
    """B2 and B3 against the plain backward at every B1 case; the full
    autograd gradient against autograd through the plain forward;
    bit-reproducibility; segment isolation. Then times both kernels at the
    1.3B training shape, against ``sdpa_bwd`` = (backend, device ms) of the
    fastest SDPA backward there."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(10)
    worst = {}
    for name, b, t, h, d, causal, dtype, packed in cases:
        qkv = torch.randn((b, t, 3 * h * d), generator=gen).to(dev, dtype)
        q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
        seg = _segments(b, t, gen, dev) if packed else None
        do = torch.randn((b, t, h, d), generator=gen).to(dev, dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     segment_ids=seg)
        want = fa.flash_attention_backward_reference(
            q, k, v, o, lse, do, causal=causal, segment_ids=seg)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       segment_ids=seg)
        # the whole gradient: the autograd Function against autograd
        # through the plain forward, for the same cotangent
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        fa.flash_attention(*leaves, causal=causal,
                           segment_ids=seg).backward(do)
        ref_leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o_ref, _ = fa.flash_attention_reference(*ref_leaves, causal=causal,
                                                segment_ids=seg)
        o_ref.backward(do)
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[-1]
        tol = GRAD_REL_TOL[dname]
        line = {"phase": "kernel", "kernel": "flash_attention_bwd",
                "case": name, "shape": [b, t, h, d], "causal": causal,
                "dtype": str(dtype), "segments": packed, "rel_tol": tol,
                "rel_err": {n: _rel_err(g, w)
                            for n, g, w in zip(("dq", "dk", "dv"), got, want)},
                "autograd_rel_err": {
                    n: _rel_err(a.grad, r.grad) for n, a, r in
                    zip(("dq", "dk", "dv"), leaves, ref_leaves)},
                "max_abs_err": {n: float((g.float() - w.float()).abs().max())
                                for n, g, w in zip(("dq", "dk", "dv"), got, want)},
                "bit_reproducible": all(torch.equal(x, y)
                                        for x, y in zip(got, again)),
                "finite": all(bool(torch.isfinite(x).all()) for x in got)}
        errs = list(line["rel_err"].values()) + list(line["autograd_rel_err"].values())
        ok = max(errs) <= tol and line["bit_reproducible"] and line["finite"]
        if packed:
            # another segment's keys and values must not touch a row's dq
            target = seg[0, t // 2].item()
            hit = (seg == target)[:, :, None, None]
            k2 = k + 5 * torch.randn(k.shape, generator=gen).to(dev, dtype) * hit
            v2 = v - 3 * torch.randn(v.shape, generator=gen).to(dev, dtype) * hit
            o2, lse2 = fa.flash_attention_fwd(q, k2, v2, causal=causal,
                                              segment_ids=seg)
            dq2, _, _ = fa.flash_attention_bwd(q, k2, v2, o2, lse2, do,
                                               causal=causal, segment_ids=seg)
            keep = ~hit[..., 0, 0]
            line["isolated_dq_bit_exact"] = bool(torch.equal(dq2[keep],
                                                             got[0][keep]))
            ok = ok and line["isolated_dq_bit_exact"]
        emit(line)
        if not ok:
            raise AssertionError(f"flash_attention_bwd {name}: {line}")
        for n, e in line["max_abs_err"].items():
            worst[n] = max(worst.get(n, 0.0), e)

    # timing at the 1.3B training shape
    b, t, h, d = 4, 1024, 16, 128
    qkv = torch.randn((b, t, 3 * h * d), generator=gen).to(dev, torch.bfloat16)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    do = torch.randn((b, t, h, d), generator=gen).to(dev, torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v)
    scale = d ** -0.5
    delta = fa.bwd_delta(o, do)
    args = (q, k, v, lse, delta, do, None, True, scale)
    dq_t = device_ms(lambda: fa._launch_dq(*args))
    dkv_t = device_ms(lambda: fa._launch_dkv(*args))
    event = {"dq": cuda_ms(lambda: fa._launch_dq(*args)),
             "dkv": cuda_ms(lambda: fa._launch_dkv(*args))}
    plain_ms = device_ms(lambda: fa.flash_attention_backward_reference(
        q, k, v, o, lse, do), iters=5)["ms"]
    pairs = b * t * (t + 1) // 2
    bthd, bht = b * t * h * d * 2, b * h * t * 4
    entries = []
    for name, key, replaces, dev_t, n_ops, nbytes, err in (
            ("flash_attention_bwd_dq", "dq", "flash_attention.py:157", dq_t,
             6 * pairs * h * d, 5 * bthd + 2 * bht, worst["dq"]),
            ("flash_attention_bwd_dkv", "dkv", "flash_attention.py:207", dkv_t,
             8 * pairs * h * d, 6 * bthd + 2 * bht,
             max(worst["dk"], worst["dv"]))):
        bound_ms, bound_by = _bound(n_ops, nbytes, "bfloat16")
        ms = dev_t["ms"]
        entry = {"name": name, "route": "cuda", "variant": "wgmma",
                 "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
                 "replaces": "deepspeed_tpu/ops/pallas/" + replaces,
                 "launches": None, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": sdpa_bwd[1],
                 "tflops_per_s": n_ops / ms / 1e9, "event_ms": event[key]}
        entries.append(entry)
        emit({"phase": "kernel", "kernel": name, "case": "train_1p3b",
              "timing": entry, "device_time": dev_t, "flops": n_ops,
              "bytes": nbytes, "tflops_per_s": n_ops / ms / 1e9,
              "library": f"F.scaled_dot_product_attention backward, "
                         f"{sdpa_bwd[0]} backend",
              "note": "plain_ms and library_ms compute dq, dk and dv together"})
    return entries


def check_fused_adamw():
    """B4 against its plain version over GPT-2 1.3B's parameter shapes (bf16
    p and g, f32 m and v) for 3 steps, lr, c1 and c2 read from a device
    buffer, then one step with the buffer's skip flag set, which must change
    nothing; then times the kernel, the plain version and
    torch.optim.AdamW(fused=True) on f32 copies."""
    import torch

    from deepspeed_tpu_torch.models.transformer_lm import GPT, gpt2_config
    from deepspeed_tpu_torch.ops.cuda import fused_adam as fadam

    dev = torch.device("cuda")
    shapes = [p.shape for p in GPT(gpt2_config("gpt2-1.3b")).parameters()]
    gen = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16
    ps = [(torch.randn(s, generator=gen, device=dev) * 0.02).to(bf16)
          for s in shapes]
    gs = [(torch.randn(s, generator=gen, device=dev) * 1e-2).to(bf16)
          for s in shapes]
    ms = [torch.zeros(s, device=dev) for s in shapes]
    vs = [torch.zeros(s, device=dev) for s in shapes]
    p0 = [p.clone() for p in ps]
    refs = [[x.clone() for x in xs] for xs in (ps, ms, vs)]
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    for step in (1, 2, 3):
        scalars = fadam.adamw_scalars(2e-4, step, 0.9, 0.95, dev)
        fadam.fused_adamw_apply(ps, gs, ms, vs, scalars, **hyper)
        fadam.fused_adamw_reference(*refs[:1], gs, *refs[1:], scalars, **hyper)
    # the skip flag set: the kernel must leave p, m and v alone
    before = [[x.clone() for x in xs] for xs in (ps, ms, vs)]
    fadam.fused_adamw_apply(ps, gs, ms, vs, fadam.adamw_scalars(
        2e-4, 4, 0.9, 0.95, dev, skip=True), **hyper)
    torch.cuda.synchronize()
    skip_untouched = all(torch.equal(a, b) for xs, ys in zip(before, (ps, ms, vs))
                         for a, b in zip(xs, ys))
    del before
    n = sum(p.numel() for p in ps)
    moved = sum(int((b != a).sum()) for a, b in zip(p0, refs[0])) / n
    identical = {name: all(torch.equal(a, b) for a, b in zip(xs, ys))
                 for name, xs, ys in (("p", ps, refs[0]), ("m", ms, refs[1]),
                                      ("v", vs, refs[2]))}
    max_abs = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(ps, refs[0]))
    line = {"phase": "kernel", "kernel": "fused_adamw", "case": "gpt2_1p3b_leaves",
            "tensors": len(shapes), "elements": n, "steps": 3,
            "bit_identical": identical, "p_max_abs_err": max_abs,
            "p_moved_share": moved, "min_moved_share": ADAMW_MIN_MOVED,
            "skip_flag_leaves_all_unchanged": skip_untouched}
    emit(line)
    if not (all(identical.values()) and moved >= ADAMW_MIN_MOVED
            and skip_untouched):
        raise AssertionError(f"fused_adamw: {line}")
    del refs, p0
    # lr, c1 and c2 from a device buffer written once, as a step's are
    scalars = fadam.adamw_scalars(2e-4, 4, 0.9, 0.95, dev)

    def step():
        fadam.fused_adamw_apply(ps, gs, ms, vs, scalars, **hyper)

    dev_t = device_ms(step, iters=10)
    ms_, event_ms = dev_t["ms"], cuda_ms(step, iters=10)
    plain_ms = device_ms(lambda: fadam.fused_adamw_reference(
        ps, gs, ms, vs, scalars, **hyper), iters=3, warmup=1)["ms"]
    del ms, vs
    # the yardstick: torch's fused AdamW needs one dtype for p, g, m and v
    p32 = [torch.nn.Parameter(p.float()) for p in ps]
    del ps
    for p, g in zip(p32, gs):
        p.grad = g.float()
    del gs
    opt = torch.optim.AdamW(p32, lr=2e-4, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.1, fused=True)
    library_ms = device_ms(opt.step, iters=5, warmup=2)["ms"]
    del opt, p32
    torch.cuda.empty_cache()
    nbytes = 22 * n  # bf16 p read+written, bf16 g read, f32 m, v read+written
    bound_ms, bound_by = _bound(16 * n, nbytes, "float32")
    entry = {"name": "fused_adamw", "route": "cuda", "variant": "multi-tensor",
             "source": "deepspeed_tpu_torch/csrc/fused_adamw.cu",
             "replaces": "deepspeed_tpu/ops/pallas/fused_adam.py:26",
             "launches": None, "max_abs_err": max_abs, "ms": ms_,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": library_ms, "event_ms": event_ms}
    emit({"phase": "kernel", "kernel": "fused_adamw", "case": "gpt2_1p3b_leaves",
          "timing": entry, "device_time": dev_t, "bytes": nbytes,
          "gb_per_s": nbytes / ms_ / 1e6,
          "note": "library_ms is torch.optim.AdamW(fused=True) on float32 "
                  "copies (p, g, m, v all f32: 32 bytes per element)"})
    return [entry]


def _sparse_config(family, heads, block, **kw):
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    return getattr(sa, family)(num_heads=heads, block=block, **kw)


def visible_pairs(layout, block, heads, causal=False):
    """(query, key) pairs the block-sparse kernels compute for one batch row,
    summed over heads: every active tile, or under ``causal`` the pairs with
    key <= query in them (the diagonal tiles' lower halves; tiles above
    the diagonal count none)."""
    import numpy as np

    active = np.broadcast_to(layout != 0, (heads,) + layout.shape[1:])
    if not causal:
        return int(active.sum()) * block * block
    nq, nk = layout.shape[1:]
    qb, kb = np.arange(nq)[:, None], np.arange(nk)[None, :]
    per_tile = np.where(kb < qb, block * block,
                        np.where(kb == qb, block * (block + 1) // 2, 0))
    return int((active * per_tile[None]).sum())


def block_sparse_cases():
    """``check_block_sparse``'s cases: name, layout (an array, or a config
    name and its fields), block, B, T, H, D, dtype, causal."""
    import numpy as np
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    empty = np.ones((1, 8, 8), np.int64)
    empty[0, 3] = 0                          # q-block 3 sees no key
    empty_causal = np.tril(np.ones((1, 16, 16), np.int64))
    empty_causal[0, 0, 0] = 0                # q-block 0 sees only the future
    empty_causal[0, 0, 5] = 1
    # a band with two full rows and an empty one, attended causally: the
    # full rows' walks end at the diagonal, and row 5 sees no key at all
    band_full_rows = np.zeros((1, 16, 16), np.int64)
    for r in range(16):
        band_full_rows[0, r, max(r - 1, 0):r + 2] = 1
    band_full_rows[0, [2, 9]] = 1
    band_full_rows[0, 5] = 0
    return [
        ("dense_b16_d64", ("DenseSparsityConfig", {}), 16, 2, 256, 4, 64, bf16, False),
        ("fixed_causal_b16_d128_f32", ("FixedSparsityConfig", dict(
            num_local_blocks=4, attention="unidirectional")), 16, 2, 256, 4, 128, f32, True),
        ("variable_b32_d64", ("VariableSparsityConfig", dict(
            num_random_blocks=1, local_window_blocks=[1, 2], global_block_indices=[0])),
         32, 2, 512, 4, 64, bf16, False),
        ("bigbird_causal_b128_d128", ("BigBirdSparsityConfig", dict(
            attention="unidirectional")), 128, 1, 1024, 4, 128, bf16, True),
        ("bigbird_b128_d64_f32", ("BigBirdSparsityConfig", {}), 128, 1, 1024, 2, 64, f32, False),
        ("bslongformer_b64_d64_f32", ("BSLongformerSparsityConfig", dict(
            global_block_indices=[0, 5])), 64, 2, 512, 2, 64, f32, False),
        ("local_window_causal_b16_d128", ("LocalSlidingWindowSparsityConfig", {}),
         16, 2, 512, 4, 128, bf16, True),
        ("bigbird_per_head_b32_d64", ("BigBirdSparsityConfig", dict(
            different_layout_per_head=True, seed=4)), 32, 2, 512, 4, 64, bf16, False),
        ("empty_row_b128_d64", empty, 128, 1, 1024, 2, 64, bf16, False),
        ("empty_row_causal_b16_d64_f32", empty_causal, 16, 1, 256, 2, 64, f32, True),
        ("bert_large_bigbird_4096", ("BigBirdSparsityConfig", dict(
            num_random_blocks=1, num_sliding_window_blocks=3, num_global_blocks=1)),
         128, 1, 4096, 16, 64, bf16, False),
        # several long rows per head, a layout per head: B5's row order
        # across heads
        ("long_rows_per_head_b128_d128", ("VariableSparsityConfig", dict(
            num_random_blocks=1, local_window_blocks=[2], global_block_indices=[0, 5, 9],
            horizontal_global_attention=True, different_layout_per_head=True, seed=7)),
         128, 2, 2048, 4, 128, bf16, False),
        ("bigbird_causal_b128_d64", ("BigBirdSparsityConfig", dict(
            attention="unidirectional")), 128, 2, 2048, 4, 64, bf16, True),
        ("band_full_rows_causal_b128_d64", band_full_rows, 128, 1, 2048, 4, 64, bf16,
         True),
        # the mma.sync kernels at their largest block
        ("fixed_causal_b64_d64", ("FixedSparsityConfig", dict(
            num_local_blocks=4, attention="unidirectional")), 64, 2, 1024, 2, 64, bf16, True),
        # the GPT route's shape (sparse_gpt): Mistral-7B's causal window at
        # 16384, D 128, on 4 of its 32 heads (the plain versions' [B, H, T, T]
        # f32 scores take 4.3 GB here, 34 GB at 32 heads)
        ("gpt_window_causal_b128_d128", ("LocalSlidingWindowSparsityConfig", dict(
            num_sliding_window_blocks=SPARSE_GPT_BLOCK["num_sliding_window_blocks"])),
         128, 1, SPARSE_GPT_SEQ, 4, 128, bf16, True),
    ]


def check_block_sparse():
    """B5 (forward), B6 (dq) and B7 (dk, dv) against their plain versions
    (o by max-abs and by each row's relative error, ``O_ROW_REL_TOL``; the
    plain backward on the plain forward's o and lse) at every sparsity family, blocks 16-128, D 64 and 128, bf16 and f32, causal
    and bidirectional, a per-head layout, layouts with a row that sees no
    key, and the path's own shape (BERT-Large under BigBird at 4096); the
    backward must be bit-reproducible and finite. Then times the three
    kernels at the path's shape against their bounds, their plain versions,
    F.scaled_dot_product_attention under the expanded boolean mask (the
    library call: dense work under a mask) and the port's gather path; and
    at the GPT route's shape (``time_block_sparse_gpt``)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(20)
    cases = block_sparse_cases()
    worst = {}
    path = None
    for case in cases:
        line, kept = check_sparse_case(case, gen, dev)
        worst["fwd"] = max(worst.get("fwd", 0.0), line["o_max_abs_err"])
        for n, e in line["grad_max_abs_err"].items():
            worst[n] = max(worst.get(n, 0.0), e)
        if case[0] == "bert_large_bigbird_4096":
            path = kept
        del kept
    torch.cuda.empty_cache()
    entries = time_block_sparse(path, worst)
    del path
    free_cuda()
    window = time_block_sparse_gpt()
    # and at one tp-4 rank's share of it (the parallel phase's window)
    rank = time_block_sparse_gpt(
        MISTRAL_7B["n_head"] // PARALLEL_TP,
        MISTRAL_7B["n_kv_head"] // PARALLEL_TP,
        case="gpt_window_tp4_rank_16384_timing",
        plain={"fwd": window["block_sparse_fwd"]["plain_ms_4_heads"],
               "bwd": window["block_sparse_dq"]["plain_ms_4_heads"]})
    for entry in entries:
        # B5-B7 at the GPT route's shape (Mistral-7B's causal window)
        entry["gpt_window_shape"] = window[entry["name"]]
        entry["tp4_rank_window_shape"] = rank[entry["name"]]
    return entries


def check_sparse_case(case, gen, dev):
    """One case of ``check_block_sparse``: the kernels against their plain
    versions, bit-reproducible and finite (rows that see no key: zero).
    Returns the line and the case's tensors ``(q, k, v, do, o, lse, layout,
    tables, block)``; raises when a check fails."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.cuda.common import NEG_INF

    name, lay, block, b, t, h, d, dtype, causal = case
    layout = (lay if isinstance(lay, np.ndarray)
              else _sparse_config(lay[0], h, block, **lay[1]).make_layout(t))
    tables = bsa.build_index_tables(layout, dev)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen).to(dev, dtype)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    do = torch.randn((b, t, h, d), generator=gen).to(dev, dtype)
    kw = dict(block=block, causal=causal)
    o, lse = bsa.block_sparse_fwd(q, k, v, tables, **kw)
    o2, lse2 = bsa.block_sparse_fwd(q, k, v, tables, **kw)
    o_ref, lse_ref = bsa.block_sparse_attention_reference(q, k, v, layout, **kw)
    got = bsa.block_sparse_bwd(q, k, v, o, lse, do, tables, **kw)
    again = bsa.block_sparse_bwd(q, k, v, o, lse, do, tables, **kw)
    # the plain backward runs on the plain forward's o and lse, so that a
    # fault of B5 cannot reach both sides of the backward's check
    want = bsa.block_sparse_attention_backward_reference(
        q, k, v, o_ref, lse_ref, do, layout, **kw)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    tol = TOLERANCE[dname]
    line = {"phase": "kernel", "kernel": "block_sparse_attention", "case": name,
            "shape": [b, t, h, d], "block": block, "causal": causal,
            "dtype": str(dtype), "layout_heads": int(layout.shape[0]),
            "active_tiles": int((layout != 0).sum()),
            "fwd_bit_reproducible": bool(torch.equal(o, o2) and torch.equal(lse, lse2)),
            "o_max_abs_err": float((o.float() - o_ref.float()).abs().max()),
            "lse_max_abs_err": float((lse - lse_ref).abs().max()), "tol": tol,
            "o_row_rel_err": _row_rel_err(o, o_ref),
            "o_row_rel_tol": O_ROW_REL_TOL[dname],
            "grad_rel_tol": GRAD_REL_TOL[dname],
            "grad_rel_err": {n: _rel_err(g, w) for n, g, w in
                             zip(("dq", "dk", "dv"), got, want)},
            "grad_max_abs_err": {n: float((g.float() - w.float()).abs().max())
                                 for n, g, w in zip(("dq", "dk", "dv"), got, want)},
            "ref_grad_abs_max": {n: float(w.float().abs().max())
                                 for n, w in zip(("dq", "dk", "dv"), want)},
            "bit_reproducible": all(torch.equal(x, y) for x, y in zip(got, again)),
            "finite": all(bool(torch.isfinite(x).all()) for x in (o, *got))}
    ok = (min(line["ref_grad_abs_max"].values()) > 0
          and line["o_max_abs_err"] <= tol["o"] and line["lse_max_abs_err"] <= tol["lse"]
          and line["o_row_rel_err"] <= O_ROW_REL_TOL[dname]
          and max(line["grad_rel_err"].values()) <= GRAD_REL_TOL[dname]
          and line["bit_reproducible"] and line["fwd_bit_reproducible"]
          and line["finite"])
    if name.startswith("empty_row") or name.startswith("band_full_rows"):
        seen = lse_ref > 0.5 * NEG_INF
        line["empty_rows_zero"] = bool((o.float().transpose(1, 2)[~seen] == 0).all()
                                       and (got[0].float().transpose(1, 2)[~seen] == 0).all()
                                       and (lse[~seen] == lse_ref[~seen]).all()
                                       and bool((~seen).any()))
        ok = ok and line["empty_rows_zero"]
    emit(line)
    if not ok:
        raise AssertionError(f"block_sparse_attention {name}: {line}")
    return line, (q, k, v, do, o, lse, layout, tables, block)


def time_block_sparse_gpt(h=None, kv_heads=None,
                          case="gpt_window_causal_16384_timing", plain=None):
    """B5, B6 and B7 at the GPT route's shape, Mistral-7B's causal window
    at [1, 16384, 32, 128] bf16, block 128 (a layout shared by the heads),
    or at ``h`` heads whose keys and values repeat ``kv_heads`` (one tp-4
    rank's share, [1, 16384, 8, 128] from 2 KV heads; then each kernel is
    first held against its plain version on the first 2 heads; ``plain``:
    the plain versions' times at 4 heads, measured already):
    device time against the bound over the causal visible pairs, against
    F.scaled_dot_product_attention under the expanded [T, T] boolean mask
    (the library call: the same function, dense work under the mask), and
    against B1-B3 over full causal attention at the same shape (what the
    plain Mistral config runs). The plain versions hold [B, H, T, T] f32
    scores, so they are timed at 4 heads (the kernel phase's
    ``gpt_window_causal_b128_d128`` case checks the kernels against them
    there). Returns ``{kernel: {...}}`` for the kernels line."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    b, t, d = 1, SPARSE_GPT_SEQ, 128
    h = h or MISTRAL_7B["n_head"]
    kv = kv_heads or h
    block = SPARSE_GPT_BLOCK["block"]
    layout = _sparse_config(
        "LocalSlidingWindowSparsityConfig", h, block,
        num_sliding_window_blocks=SPARSE_GPT_BLOCK["num_sliding_window_blocks"]
    ).make_layout(t)
    tables = bsa.build_index_tables(layout, "cuda")
    gen = torch.Generator().manual_seed(60)
    q, k, v, do = (torch.randn((b, t, n, d), generator=gen)
                   .to("cuda", torch.bfloat16) for n in (h, kv, kv, h))
    if kv != h:
        # the GQA repeat the attention hands the kernels (contiguous)
        k, v = (x.repeat_interleave(h // kv, dim=2) for x in (k, v))
    scale = d ** -0.5
    o, lse = bsa.block_sparse_fwd(q, k, v, tables, block=block, causal=True)
    check = None
    if kv_heads is not None:
        # each kernel against its plain version on the first 2 heads (the
        # plain versions hold [B, H, T, T] f32 scores)
        got = bsa.block_sparse_bwd(q, k, v, o, lse, do, tables, block=block,
                                   causal=True)
        cut = [x[:, :, :2].contiguous() for x in (q, k, v, do)]
        o_ref, lse_ref = bsa.block_sparse_attention_reference(
            *cut[:3], layout[:1], block=block, causal=True)
        want = bsa.block_sparse_attention_backward_reference(
            *cut[:3], o_ref, lse_ref, cut[3], layout[:1], block=block,
            causal=True)
        torch.cuda.synchronize()
        tol = TOLERANCE["bfloat16"]
        check = {"o_max_abs_err": float((o[:, :, :2].float()
                                         - o_ref.float()).abs().max()),
                 "lse_max_abs_err": float((lse[:, :2] - lse_ref)
                                          .abs().max()),
                 "grad_rel_err": {n: _rel_err(g[:, :, :2], w) for n, g, w in
                                  zip(("dq", "dk", "dv"), got, want)},
                 "tol": tol, "grad_rel_tol": GRAD_REL_TOL["bfloat16"]}
        del got, cut, o_ref, lse_ref, want
        free_cuda()
        if not (check["o_max_abs_err"] <= tol["o"]
                and check["lse_max_abs_err"] <= tol["lse"]
                and max(check["grad_rel_err"].values())
                <= GRAD_REL_TOL["bfloat16"]):
            emit({"phase": "kernel", "kernel": "block_sparse_attention",
                  "case": case, "check": check})
            raise AssertionError(f"block_sparse_attention {case}: {check}")
    delta = fa.bwd_delta(o, do)
    args = (q, k, v, lse, delta, do, tables, block, True, scale)
    times = {"block_sparse_fwd": device_ms(lambda: bsa._launch_fwd(
                 q, k, v, tables, block, True, scale)),
             "block_sparse_dq": device_ms(lambda: bsa._launch_dq(*args)),
             "block_sparse_dkv": device_ms(lambda: bsa._launch_dkv(*args))}
    # B1-B3 over full causal attention at the same shape
    fo, flse = fa.flash_attention_fwd(q, k, v, causal=True)
    fdelta = fa.bwd_delta(fo, do)
    fargs = (q, k, v, flse, fdelta, do, None, True, scale)
    flash = {"flash_attention_fwd": device_ms(
                 lambda: fa._launch(q, k, v, None, True, scale))["ms"],
             "flash_attention_bwd_dq": device_ms(
                 lambda: fa._launch_dq(*fargs))["ms"],
             "flash_attention_bwd_dkv": device_ms(
                 lambda: fa._launch_dkv(*fargs))["ms"]}
    del fo, flse, fdelta, fargs
    if plain is None:
        # the plain versions at 4 heads
        cut = [x[:, :, :4].contiguous() for x in (q, k, v, do)]
        o4, lse4 = bsa.block_sparse_attention_reference(
            *cut[:3], layout[:1], block=block, causal=True)
        plain = {"fwd": device_ms(lambda: bsa.block_sparse_attention_reference(
                     *cut[:3], layout[:1], block=block, causal=True),
                     iters=3)["ms"],
                 "bwd": device_ms(
                     lambda: bsa.block_sparse_attention_backward_reference(
                         *cut[:3], o4, lse4, cut[3], layout[:1], block=block,
                         causal=True), iters=3)["ms"]}
        del cut, o4, lse4
        free_cuda()
    # the library call under the expanded boolean mask
    mask = bsa.keep_mask(layout, block, True, q.device)[0, 0]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), iters=5)["ms"]
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    sdpa_bwd = device_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=5)["ms"]
    del out, mask, qt, kt, vt
    pairs = visible_pairs(layout, block, h, causal=True) * b
    full_pairs = b * h * t * (t + 1) // 2
    bthd, bht = b * t * h * d * 2, b * h * t * 4
    out = {}
    for name, key, n_ops, nbytes, library in (
            ("block_sparse_fwd", "fwd", 4 * pairs * d, 4 * bthd + bht, sdpa_fwd),
            ("block_sparse_dq", "bwd", 6 * pairs * d, 5 * bthd + 2 * bht, sdpa_bwd),
            ("block_sparse_dkv", "bwd", 8 * pairs * d, 6 * bthd + 2 * bht, sdpa_bwd)):
        bound_ms, bound_by = _bound(n_ops, nbytes, "bfloat16")
        ms = times[name]["ms"]
        flash_name = {"block_sparse_fwd": "flash_attention_fwd",
                      "block_sparse_dq": "flash_attention_bwd_dq",
                      "block_sparse_dkv": "flash_attention_bwd_dkv"}[name]
        out[name] = {"shape": [b, t, h, d], "block": block, "causal": True,
                     "kv_heads_repeated_from": kv,
                     "ms": ms, "device_time": times[name],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "flops": n_ops, "bytes": nbytes,
                     "tflops_per_s": n_ops / ms / 1e9,
                     "plain_ms_4_heads": plain[key], "library_ms": library,
                     "library": "F.scaled_dot_product_attention under the "
                                "expanded [T, T] boolean mask",
                     "full_causal_flash_ms": flash[flash_name]}
    emit({"phase": "kernel", "kernel": "block_sparse_attention",
          "case": case, "shape": [b, t, h, d], "check": check,
          "visible_pairs_per_head": pairs // (b * h),
          "full_causal_pairs_per_head": full_pairs // (b * h),
          "visible_share": pairs / full_pairs, "timing": out,
          "kernels_fwd_bwd_ms": sum(times[n]["ms"] for n in times),
          "full_causal_flash_fwd_bwd_ms": sum(flash.values()),
          "note": "plain and SDPA backward times compute dq, dk and dv "
                  "together; the plain versions at 4 heads"})
    del q, k, v, do, o, lse, delta, args, tables
    free_cuda()
    return out


def time_block_sparse(path, worst):
    """B5, B6 and B7 at the path's shape against their bounds, plain
    versions, SDPA under the expanded mask and the gather path."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.cuda.flash_attention import bwd_delta
    from deepspeed_tpu_torch.ops.sparse_attention import (
        gathered_blocksparse_attention)
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
        _build_index_tables)

    q, k, v, do, o, lse, layout, tables, block = path
    b, t, h, d = q.shape
    scale = d ** -0.5
    delta = bwd_delta(o, do)
    args = (q, k, v, lse, delta, do)
    # each kernel with its rows (B5, B6) or columns (B7) longest first (the
    # path's tables) and in natural order, in turns: longest, natural,
    # natural, longest
    natural = dataclasses.replace(tables, **{
        f: torch.arange(tables.korder.numel(), dtype=torch.int32, device=q.device)
        for f in ("korder", "qorder")})
    launch = {"fwd": lambda tab: bsa.block_sparse_fwd(q, k, v, tab, block=block),
              "dq": lambda tab: bsa._launch_dq(*args, tab, block, False, scale),
              "dkv": lambda tab: bsa._launch_dkv(*args, tab, block, False, scale)}
    order_t = {key: {"longest_first": [], "natural": []} for key in launch}
    for key, fn in launch.items():
        for which in ("longest_first", "natural", "natural", "longest_first"):
            tab = tables if which == "longest_first" else natural
            order_t[key][which].append(device_ms(lambda: fn(tab))["ms"])
    # the makespan probe: each kernel on the layout's longest rows and
    # columns alone (BigBird's global row and column of each head), the
    # same inputs; a time close to the whole layout's says those blocks set
    # the kernel's time
    active = layout != 0
    longest = np.zeros_like(active)
    for hl, lay in enumerate(active):
        rows, cols = lay.sum(1) == lay.sum(1).max(), lay.sum(0) == lay.sum(0).max()
        longest[hl][rows], longest[hl][:, cols] = lay[rows], lay[:, cols]
    alone = bsa.build_index_tables(longest.astype(np.int64), q.device)
    longest_alone_ms = {key: device_ms(lambda: fn(alone))["ms"] for key, fn in launch.items()}

    def fwd():
        bsa.block_sparse_fwd(q, k, v, tables, block=block)

    dev_t = {"fwd": device_ms(fwd)}
    event = {"fwd": cuda_ms(fwd)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        bsa.block_sparse_fwd(q, k, v, tables, block=block)
    host_us = (time.perf_counter() - t0) / 20 * 1e6  # enqueue only, no sync
    torch.cuda.synchronize()
    # what SparseSelfAttention pays per call to find its tables: a hit in
    # the bounded cache, keyed by the layout's bytes
    _build_index_tables(layout, h, block, q.device)
    t0 = time.perf_counter()
    for _ in range(1000):
        _build_index_tables(layout, h, block, q.device)
    lookup_us = (time.perf_counter() - t0) / 1000 * 1e6
    fwd_plain_ms = device_ms(lambda: bsa.block_sparse_attention_reference(
        q, k, v, layout, block=block), iters=5)["ms"]
    for key in ("dq", "dkv"):
        fn = functools.partial(launch[key], tables)
        dev_t[key], event[key] = device_ms(fn), cuda_ms(fn)
    fwd_ms, dq_ms, dkv_ms = (dev_t[k]["ms"] for k in ("fwd", "dq", "dkv"))
    bwd_plain_ms = device_ms(lambda: bsa.block_sparse_attention_backward_reference(
        q, k, v, o, lse, do, layout, block=block), iters=3)["ms"]
    gather_ms = device_ms(lambda: gathered_blocksparse_attention(
        q, k, v, layout, block=block), iters=5)["ms"]
    # the library call: SDPA over [B, H, T, D] with the boolean [T, T] mask
    mask = bsa.keep_mask(layout, block, False, q.device)[0, 0]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_fwd_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))["ms"]
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    dot = do.transpose(1, 2)
    sdpa_bwd_ms = device_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                        retain_graph=True))["ms"]
    sdpa_fwd_bwd_ms = device_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), (qt, kt, vt),
        dot))["ms"]
    del out, mask
    pairs = visible_pairs(layout, block, h) * b
    bthd, bht = b * t * h * d * q.element_size(), b * h * t * 4
    source = "deepspeed_tpu_torch/csrc/block_sparse_attention.cu"
    replaces = "deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py:"
    entries = []
    for name, key, line_no, ms, n_ops, nbytes, err, plain, lib in (
            ("block_sparse_fwd", "fwd", 84, fwd_ms, 4 * pairs * d, 4 * bthd + bht,
             worst["fwd"], fwd_plain_ms, sdpa_fwd_ms),
            ("block_sparse_dq", "dq", 129, dq_ms, 6 * pairs * d, 5 * bthd + 2 * bht,
             worst["dq"], bwd_plain_ms, sdpa_bwd_ms),
            ("block_sparse_dkv", "dkv", 168, dkv_ms, 8 * pairs * d, 6 * bthd + 2 * bht,
             max(worst["dk"], worst["dv"]), bwd_plain_ms, sdpa_bwd_ms)):
        bound_ms, bound_by = _bound(n_ops, nbytes, "bfloat16")
        entry = {"name": name, "route": "cuda",
                 "variant": bsa.kernel_variant(q.dtype, block), "source": source,
                 "replaces": replaces + str(line_no), "launches": None,
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
                 "tflops_per_s": n_ops / ms / 1e9, "event_ms": event[key]}
        # rows (columns for B7) stay whole, no split; the longest go first
        entry.update(split=False, longest_first_ms=order_t[key]["longest_first"],
                     natural_order_ms=order_t[key]["natural"],
                     longest_alone_ms=longest_alone_ms[key])
        entries.append(entry)
        emit({"phase": "kernel", "kernel": name, "case": "bert_large_bigbird_4096",
              "timing": entry, "device_time": dev_t[key], "flops": n_ops,
              "bytes": nbytes,
              "visible_pairs": pairs, "tflops_per_s": n_ops / ms / 1e9})
    emit({"phase": "kernel", "kernel": "block_sparse_attention",
          "case": "bert_large_bigbird_4096",
          "sdpa_masked_ms": {"fwd": sdpa_fwd_ms, "bwd": sdpa_bwd_ms,
                             "fwd_bwd": sdpa_fwd_bwd_ms},
          "kernels_fwd_bwd_ms": fwd_ms + dq_ms + dkv_ms,
          "longest_alone_tiles": int(longest.sum()),
          "fwd_wrapper_host_us_per_call": host_us,
          "tables_lookup_host_us_per_call": lookup_us,
          "gather_fwd_ms": gather_ms,
          "note": "plain and SDPA backward times compute dq, dk and dv together; "
                  "delta's rowsum is not in the kernel times"})
    return entries


def phase_serve():
    """GPT-2 1.3B through init_inference, the port's serving path."""
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer_lm import (
        GPT, gpt2_config, num_params)
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    cfg = gpt2_config("gpt2-1.3b", use_flash_attention=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = init_inference(GPT(cfg), dtype="bf16", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (4, 1024), generator=gen)
    lengths = [37, 64, 100, 128]
    prompts = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen)
    mask = torch.arange(128)[None, :] < torch.tensor(lengths)[:, None]
    prompts = prompts * mask

    reset_launches()
    logits = engine(ids)
    torch.cuda.synchronize()
    forward_launches = fa.launches
    toks = engine.generate(prompts, max_new_tokens=32, attention_mask=mask)
    torch.cuda.synchronize()
    launches = read_launches()

    if forward_launches != cfg.n_layer:
        raise AssertionError(f"forward launched flash_attention_fwd "
                             f"{forward_launches} times, want {cfg.n_layer}")
    if tuple(logits.shape) != (4, 1024, cfg.vocab_size) or \
            logits.dtype != torch.float32:
        raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits on the flash path")
    if tuple(toks.shape) != (4, 32) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned {tuple(toks.shape)}, "
                             f"range [{toks.min()}, {toks.max()}]")

    einsum = init_inference(
        GPT(gpt2_config("gpt2-1.3b", use_flash_attention=False)),
        dtype="bf16", state_dict=engine.module.state_dict())
    logits_e = einsum(ids)
    diff = (logits - logits_e).abs().max().item()
    top1 = (logits.argmax(-1) == logits_e.argmax(-1)).float().mean().item()
    del logits_e, einsum

    forward_ms = wall_ms(lambda: engine(ids))
    fa.launches = 0
    decode = compare_decode(engine, prompts, mask)
    gen1_ms = wall_ms(lambda: engine.generate(prompts, max_new_tokens=1,
                                              attention_mask=mask), reps=3)
    gen32_ms = wall_ms(lambda: engine.generate(prompts, max_new_tokens=32,
                                               attention_mask=mask), reps=3)
    eager32_ms = wall_ms(lambda: eager_generate(engine, prompts, 32, mask),
                         reps=3)
    line = {"phase": "serve", "model": "gpt2-1.3b",
            "params": num_params(cfg), "dtype": "bf16", "init_s": init_s,
            "forward_shape": [4, 1024], "forward_launches": forward_launches,
            "launches": launches,
            "flash_vs_einsum_max_abs_logit_diff": diff,
            "flash_vs_einsum_top1_agreement": top1,
            "forward_ms": forward_ms,
            "forward_tokens_per_s": 4 * 1024 / forward_ms * 1e3,
            "prompt_lengths": lengths, "new_tokens": 32,
            "prefill_ms": gen1_ms,
            "decode_ms_per_token": (gen32_ms - gen1_ms) / 31,
            "eager_decode_ms_per_token": (eager32_ms - gen1_ms) / 31,
            "decode_chunk": engine.decode_chunk,
            "decode_graphs_vs_eager": decode,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(line)
    if not (top1 >= SERVE_TOP1_MIN and diff <= SERVE_MAX_ABS_LOGIT_DIFF):
        raise AssertionError(
            f"flash vs einsum logits: top-1 agreement {top1} (min "
            f"{SERVE_TOP1_MIN}), max abs diff {diff} (max "
            f"{SERVE_MAX_ABS_LOGIT_DIFF})")
    if not decode["identical"]:
        raise AssertionError(f"decode graphs against eager decode: {decode}")
    phase_profile(engine, ids, prompts, mask)
    return launches


def eager_generate(engine, prompts, n, mask=None, temperature=0.0):
    """``generate`` with every decode step called uncaptured, one token
    per run (decode_chunk 1)."""
    chunk, engine.decode_chunk = engine.decode_chunk, 1
    try:
        return engine._generate(prompts, n, temperature, mask, eager=True)
    finally:
        engine.decode_chunk = chunk


def compare_decode(engine, prompts, mask=None, n=32, seed=7,
                   temperatures=(("greedy", 0.0), ("sampled", 0.8))):
    """Tokens of ``generate(n)`` from the decode graphs against eager
    decode, greedy and sampled (temperature 0.8, the engine's generator
    seeded alike before each), over three calls: a run length's first use
    runs uncaptured (the warm-up), its second captures, later ones
    replay."""
    out = {}
    for name, temp in temperatures:
        calls = []
        for _ in range(3):
            engine._generator.manual_seed(seed)
            calls.append(engine.generate(prompts, max_new_tokens=n,
                                         temperature=temp,
                                         attention_mask=mask))
        engine._generator.manual_seed(seed)
        eager = eager_generate(engine, prompts, n, mask, temp)
        out[name] = [bool((c == eager).all()) for c in calls]
    out["identical"] = all(all(v) for v in out.values())
    return out


def _trace(fn):
    """Run ``fn`` under torch.profiler; the card's kernel time by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms_ = (time.perf_counter() - t0) * 1e3
    by_name, count, n = {}, {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
            count[e.name] = count.get(e.name, 0) + 1
            n += 1
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # the host side: operators by their own CPU time (tracing inflates it)
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:8]
    return {"wall_ms": wall_ms_, "device_ms": device_ms, "kernels": n,
            "device_busy_share": device_ms / wall_ms_,
            "top_ms": [[name[:90], ms] for name, ms in top],
            "host_top_self_ms": [[a.key[:60], a.self_cpu_time_total / 1e3, a.count]
                                 for a in host]}, by_name, count


def phase_profile(engine, ids, prompts, mask):
    """Where the card's time goes in one traced forward and one traced
    8-token generate (tracing slows the host, so wall times here read high)."""
    fwd, by_name, _ = _trace(lambda: engine(ids))
    flash_ms = sum(ms for name, ms in by_name.items()
                   if "flash_fwd_" in name)
    fwd["flash_ms"] = flash_ms
    fwd["flash_share_of_device"] = (flash_ms / fwd["device_ms"]
                                    if fwd["device_ms"] else None)
    gen, _, _ = _trace(lambda: engine.generate(prompts, max_new_tokens=8,
                                               attention_mask=mask))
    emit({"phase": "profile", "forward_4x1024": fwd,
          "generate_4_prompts_8_tokens": gen})


def phase_small():
    """A small fp32 GPT on the card: cached greedy decode must equal an
    argmax rollout of the full forward."""
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer_lm import GPT, GPTConfig

    cfg = GPTConfig(vocab_size=512, n_positions=256, n_embd=256, n_layer=2,
                    n_head=4, dtype=torch.float32, use_flash_attention=True)
    engine = init_inference(GPT(cfg), dtype="fp32", seed=3)
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
    toks = engine.generate(ids, max_new_tokens=8).cpu()
    cur, expect = ids, []
    for _ in range(8):
        nxt = engine(cur)[:, -1].argmax(-1).cpu()
        expect.append(nxt)
        cur = torch.cat([cur, nxt[:, None]], dim=1)
    expect = torch.stack(expect, dim=1)
    same = bool(torch.equal(toks, expect))
    decode = compare_decode(engine, ids)
    emit({"phase": "small", "tokens_identical_to_rollout": same,
          "decode_graphs_vs_eager": decode})
    if not same:
        raise AssertionError(f"cached decode {toks.tolist()} != rollout "
                             f"{expect.tolist()}")
    if not decode["identical"]:
        raise AssertionError(f"decode graphs against eager decode: {decode}")


def reset_launches():
    from deepspeed_tpu_torch.runtime import compiled_step

    compiled_step.reset_launch_counts()


def read_launches():
    """Every kernel's launches since the last reset: wrapper calls, plus,
    for each replay of a CUDA graph, the launches its capture saw."""
    from deepspeed_tpu_torch.runtime import compiled_step

    return compiled_step.launch_counts()


def free_cuda():
    """Drop what the last phase left (engines and their graphs sit in
    reference cycles: each step function is a bound method of its engine)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def train_steps(engine, it, n, eager=False, probe=None):
    """``n`` fenced ``train_batch`` steps (``eager``: the step functions
    called uncaptured; ``probe(engine)``, when given, runs before each).
    Returns the losses and the grad norms (tensors) and the host ms of each
    step."""
    import torch

    losses, norms, times = [], [], []
    for _ in range(n):
        if probe is not None:
            probe(engine)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(engine._train_batch(it, eager=eager))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        norms.append(engine._last_grad_norm)
    return losses, norms, times


def identical(xs, ys):
    """Whether two lists of tensors (or of None) are equal bit for bit."""
    import torch

    return len(xs) == len(ys) and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and torch.equal(x, y))
        for x, y in zip(xs, ys))


def first_difference(a, b):
    """The first name whose tensors differ in two state dicts, and the
    largest difference there (None when they are equal)."""
    import torch

    for name, x in a.items():
        y = b[name]
        if not torch.equal(x, y):
            return {"tensor": name,
                    "max_abs_diff": float((x.float() - y.float()).abs().max())}
    return None


def captured_against_eager(make_engine, batches, steps, traced=None,
                           probe=None):
    """The captured steps against the uncaptured ones: ``steps`` steps of a
    fresh engine from ``make_engine()`` through ``train_batch`` (its first
    steps warm the capture up, the rest replay graphs), then as many of a
    second engine from the same seed with its step functions called
    directly. ``traced(engine, data_iter)``, when given, runs on the
    captured engine after its steps (a traced replay); ``probe(engine)``
    before every step of both runs. The first engine is freed before the
    second is built. Returns the comparison (with the card's peak
    allocated GB up to the end of the captured steps, before this check
    copies the parameters, the eager run's peak, and each run's state: what
    was allocated once its engine was built), the captured run's launches,
    losses, grad norms and host ms, and the eager run's losses and host
    ms."""
    import torch

    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    reset_launches()
    engine = make_engine()
    state_gb = torch.cuda.memory_allocated() / 1e9
    it = iter(RepeatingLoader(batches))
    losses, norms, times = train_steps(engine, it, steps, probe=probe)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    graphs = {name: [dict(g.launches, replays=g.replays)
                     for g in getattr(engine, name).graphs.values()]
              for name in ("_fused", "_micro", "_apply")}
    params = {k: v.clone() for k, v in engine.params.items()}
    result = {"captured_graph_launches": graphs,
              "peak_allocated_gb": peak_gb, "state_gb": state_gb,
              "loss_scale": engine.loss_scale,
              "optimizer_count": engine.optimizer.count}
    if traced is not None:
        traced(engine, it)
    del engine, it
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    eager = make_engine()
    e_state_gb = torch.cuda.memory_allocated() / 1e9
    e_losses, e_norms, e_times = train_steps(
        eager, iter(RepeatingLoader(batches)), steps, eager=True,
        probe=probe)
    e_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    e_params = eager.params
    diff = first_difference(params, e_params)
    result.update(
        eager_peak_allocated_gb=e_peak_gb,
        # the eager steps' peak above what was allocated before them (the
        # engine's state, and anything the caller holds): the activations
        # and the step's transients
        eager_peak_above_state_gb=e_peak_gb - e_state_gb,
        losses_identical=identical(losses, e_losses),
        grad_norms_identical=identical(norms, e_norms),
        params_identical=diff is None, first_param_difference=diff,
        eager_loss_scale=eager.loss_scale,
        eager_optimizer_count=eager.optimizer.count)
    del eager, e_params, params
    free_cuda()
    result["identical"] = (result["losses_identical"]
                           and result["grad_norms_identical"]
                           and result["params_identical"]
                           and result["loss_scale"] == result["eager_loss_scale"]
                           and result["optimizer_count"]
                           == result["eager_optimizer_count"])
    return (result, launches, [float(x) for x in losses],
            [None if x is None else float(x) for x in norms], times,
            [float(x) for x in e_losses], e_times)


def gpt_flops_per_token(cfg, seq):
    """Model training FLOPs per token of a causal GPT: 6N for the
    non-embedding parameters plus the attention term (the formula of
    benchmarks/_util.py:11-18)."""
    from deepspeed_tpu_torch.models.transformer_lm import num_params

    embed = cfg.vocab_size * cfg.n_embd
    attn = 6 * cfg.n_layer * cfg.n_embd * seq
    return 6.0 * (num_params(cfg) - embed) + attn


# benchmarks/gpt_pretrain.py:51-61 with its CLI micro batch (:92), plus the
# device block that routes FusedAdam to the fused kernel (B4)
GPT_PRETRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 4,
    "gradient_accumulation_steps": 1,
    "bf16": {"enabled": True},
    "gradient_clipping": 1.0,
    "optimizer": {"type": "FusedAdam",
                  "params": {"lr": 2e-4, "betas": [0.9, 0.95],
                             "weight_decay": 0.1}},
    "zero_optimization": {"stage": 1},
    "steps_per_print": 10 ** 9,
    "tpu": {"use_pallas_optimizer": True},
}
# train_batch steps of each training run: the engine's capture warm-up
# steps (CompiledStep's default, 2: real steps, uncaptured), then 10 graph
# replays, the first of which follows the capture
CAPTURE_WARMUP, CAPTURED_STEPS = 2, 10
STEPS = CAPTURE_WARMUP + CAPTURED_STEPS
PER_STEP = {"flash_attention_fwd": 48, "flash_attention_bwd_dq": 24,
            "flash_attention_bwd_dkv": 24, "fused_adamw": 1}
# the flash kernels' segment-variant counts, none on an unpacked batch
UNSEGMENTED = {"flash_attention_fwd_segment": 0,
               "flash_attention_bwd_dq_segment": 0,
               "flash_attention_bwd_dkv_segment": 0}


def step_medians(times, e_times):
    """Median host ms of the captured run's replays after the capture step,
    and of the eager run's steps after as many."""
    return (statistics.median(times[CAPTURE_WARMUP + 1:]),
            statistics.median(e_times[CAPTURE_WARMUP + 1:]))


def phase_train():
    """GPT-2 1.3B through initialize -> train_batch, the training slice's
    main path: one step on the einsum path, then 12 captured steps (2
    warm-up, 10 replays) against 12 uncaptured ones from the same seed,
    through ``use_flash_attention="auto"`` as gpt_pretrain.py asks. Returns
    the kernels' launch counts on the captured run."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.models.transformer_lm import num_params

    free_cuda()
    t0 = time.perf_counter()
    einsum = gpt_1p3b_engine(flash=False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = einsum.module.config
    rng = np.random.RandomState(1)
    ids = rng.randint(0, cfg.vocab_size, size=(4, 1024)).astype(np.int64)
    batch = {"input_ids": ids, "labels": ids}

    # one step on the einsum path from the same seed's weights and batch
    loss_e = float(einsum.train_batch(iter([batch])))
    gnorm_e = einsum.get_global_grad_norm()
    del einsum
    free_cuda()

    torch.cuda.reset_peak_memory_stats()
    traces = {}
    check, launches, losses, norms, times, e_losses, e_times = \
        captured_against_eager(
            functools.partial(gpt_1p3b_engine, flash="auto"), [batch], STEPS,
            traced=lambda eng, it: traces.update(profile_step(
                eng, it, "train_step_1p3b",
                {"flash_attention_fwd": "flash_fwd_",
                 "flash_attention_bwd_dq": "bwd_dq_",
                 "flash_attention_bwd_dkv": "bwd_dkv_",
                 "fused_adamw": "adamw_kernel"}, PER_STEP)))
    loss_f, gnorm_f = losses[0], norms[0]
    ms, eager_ms = step_medians(times, e_times)
    fpt = gpt_flops_per_token(cfg, 1024)
    tflops = 4 * 1024 * fpt / ms / 1e9
    line = {"phase": "train", "model": "gpt2-1.3b", "params": num_params(cfg),
            "config": GPT_PRETRAIN_CONFIG, "use_flash_attention": "auto",
            "batch": [4, 1024],
            "init_s": init_s, "losses": losses, "eager_losses": e_losses,
            "flash_vs_einsum": {"loss": [loss_f, loss_e],
                                "grad_norm": [gnorm_f, gnorm_e]},
            "captured_vs_eager": check,
            "launches": launches, "steps": STEPS,
            "capture_warmup_steps": CAPTURE_WARMUP,
            "step_ms_median": ms, "step_ms": times,
            "eager_step_ms_median": eager_ms, "eager_step_ms": e_times,
            "capture_step_ms": times[CAPTURE_WARMUP],
            "traced_replay_device_busy_share":
                traces["train_step_1p3b"]["device_busy_share"],
            "tokens_per_s": 4 * 1024 / ms * 1e3,
            "model_flops_per_token": fpt, "model_tflops_per_s": tflops,
            "mfu_vs_989": tflops / 989.0,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(line)
    problems = []
    if not all(np.isfinite(losses)):
        problems.append("non-finite loss")
    if not losses[-1] <= losses[0] - TRAIN_MIN_LOSS_DROP:
        problems.append(f"loss did not fall by {TRAIN_MIN_LOSS_DROP}")
    for name, per in PER_STEP.items():
        if launches[name] != per * STEPS:
            problems.append(f"{name}: {launches[name]} launches, want "
                            f"{per} x {STEPS}")
    if abs(loss_f - loss_e) > TRAIN_LOSS_REL_TOL * abs(loss_e):
        problems.append("flash and einsum losses disagree")
    if abs(gnorm_f - gnorm_e) > TRAIN_GNORM_REL_TOL * abs(gnorm_e):
        problems.append("flash and einsum grad norms disagree")
    if not check["identical"]:
        problems.append("captured and eager steps differ")
    problems += traces["train_step_1p3b"]["problems"]
    if problems:
        raise AssertionError(f"train: {problems}")
    return launches


def gpt_1p3b_engine(seed=0, flash=True, config=None, model="gpt2-1.3b"):
    """GPT-2 1.3B (or ``model``) through ``initialize`` with
    ``GPT_PRETRAIN_CONFIG`` (the ``train``, ``checkpoint`` and ``zero``
    phases' engine), or ``config``."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT, gpt2_config

    model = GPT(gpt2_config(
        model, n_positions=1024, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, remat=True, remat_policy="full",
        use_flash_attention=flash))
    return deepspeed_tpu_torch.initialize(
        model=model, config=config or GPT_PRETRAIN_CONFIG, seed=seed)[0]


class PeakRSS:
    """The resident set of this process on the host, sampled every 20 ms
    on a thread while the ``with`` block runs: ``before_gib``,
    ``peak_gib``."""

    def __enter__(self):
        import threading

        self.before_gib = self.peak_gib = self._rss_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss_gib():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2 ** 20
        raise RuntimeError("no VmRSS in /proc/self/status")

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak_gib = max(self.peak_gib, self._rss_gib())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_gib = max(self.peak_gib, self._rss_gib())
        return False


def timed(fn):
    """``fn()`` fenced on both sides; returns its result and its seconds."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# a tag of GPT-2 1.3B holds bf16 parameters and f32 m and v, 10 bytes per
# parameter (13.1 GB); the small models' tags need little more
CKPT_MIN_FREE_BYTES = 15e9
CKPT_DIR = os.path.join("build", "chip_smoke_checkpoint")
CKPT_STEPS_BEFORE, CKPT_STEPS_AFTER = 4, 3
CKPT_SMALL_STEPS = 6


def graphs_of(engine):
    """The engine's CUDA graphs: (step, key) -> (graph, replays)."""
    return {(name, key): (g.graph, g.replays)
            for name in ("_fused", "_micro", "_apply")
            for key, g in getattr(engine, name).graphs.items()}


def same_graphs(before, after, more_replays=None):
    """Whether the engine kept the same graph objects, each replayed
    ``more_replays`` more times when given."""
    return set(before) == set(after) and all(
        before[k][0] is after[k][0]
        and (more_replays is None or after[k][1] == before[k][1] + more_replays)
        for k in before)


def phase_checkpoint():
    """GPT-2 1.3B saved, loaded into the live engine and into a fresh one,
    and served from the tag; then the small-model checks. Returns the
    kernels' launch counts over the 1.3B part (the path's)."""
    free_cuda()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    free = shutil.disk_usage(CKPT_DIR).free
    if free < CKPT_MIN_FREE_BYTES:
        raise AssertionError(
            f"checkpoint: {free / 1e9:.1f} GB free under {CKPT_DIR}, the "
            f"phase needs {CKPT_MIN_FREE_BYTES / 1e9:.0f} GB")
    try:
        launches = checkpoint_1p3b()
        checkpoint_small()
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return launches


def checkpoint_1p3b():
    import numpy as np
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer_lm import GPT, gpt2_config
    from deepspeed_tpu_torch.runtime import checkpoint_manifest as cm
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    save_dir = os.path.join(CKPT_DIR, "gpt2_1p3b")
    engine = gpt_1p3b_engine(seed=0)
    cfg = engine.module.config
    rng = np.random.RandomState(3)
    batches = [{"input_ids": x, "labels": x} for x in rng.randint(
        0, cfg.vocab_size, size=(CKPT_STEPS_AFTER, 4, 1024))]

    def run(eng):
        return train_steps(eng, iter(RepeatingLoader(batches)),
                           CKPT_STEPS_AFTER)

    reset_launches()
    before_ms = train_steps(engine, iter(RepeatingLoader(batches)),
                            CKPT_STEPS_BEFORE)[2]
    at_save = {k: v.clone() for k, v in engine.module.state_dict().items()}
    with PeakRSS() as save_rss:
        _, save_s = timed(lambda: engine.save_checkpoint(
            save_dir, client_state={"note": "chip_smoke"}))
    tag = f"global_step{CKPT_STEPS_BEFORE}"
    tag_dir = os.path.join(save_dir, tag)
    manifest = cm.read_manifest(tag_dir)
    nbytes = sum(entry["bytes"] for entry in manifest["files"].values())
    problems, verify_s = timed(lambda: cm.verify_tag_dir(tag_dir))

    # 3 steps; the load into the same engine; the same 3 steps again
    losses1, norms1, ms1 = run(engine)
    params1 = {k: v.clone() for k, v in engine.module.state_dict().items()}
    graphs = graphs_of(engine)
    with PeakRSS() as load_rss:
        (got_tag, client), load_s = timed(
            lambda: engine.load_checkpoint(save_dir))
    restored = first_difference(at_save, engine.module.state_dict())
    count_after_load = engine.optimizer.count
    path_launches = read_launches()
    reset_launches()
    losses2, norms2, ms2 = run(engine)
    after_load = read_launches()
    same_engine = {
        "losses_identical": identical(losses1, losses2),
        "grad_norms_identical": identical(norms1, norms2),
        "first_param_difference": first_difference(
            params1, engine.module.state_dict()),
        "graphs_kept": same_graphs(graphs, graphs_of(engine),
                                   CKPT_STEPS_AFTER)}
    del engine
    free_cuda()

    # a second engine, from another seed, loads the tag
    fresh = gpt_1p3b_engine(seed=1)
    with PeakRSS() as fresh_rss:
        (fresh_tag, _), fresh_load_s = timed(
            lambda: fresh.load_checkpoint(save_dir))
    reset_launches()
    losses3, norms3, _ = run(fresh)
    fresh_launches = read_launches()
    fresh_engine = {
        "tag": fresh_tag,
        "losses_identical": identical(losses1, losses3),
        "grad_norms_identical": identical(norms1, norms3),
        "first_param_difference": first_difference(
            params1, fresh.module.state_dict())}
    del fresh, params1
    free_cuda()

    # serving: the tag against the saving engine's state_dict at the save
    serve_cfg = gpt2_config("gpt2-1.3b", use_flash_attention=True)
    ids = torch.randint(0, cfg.vocab_size, (4, 1024),
                        generator=torch.Generator().manual_seed(5))
    reset_launches()
    served, serve_init_s = timed(lambda: init_inference(
        GPT(serve_cfg), dtype="bf16", checkpoint=tag_dir))
    logits_ckpt = served(ids)
    del served
    reference = init_inference(GPT(serve_cfg), dtype="bf16", state_dict=at_save)
    logits_sd = reference(ids)
    serve_launches = read_launches()
    served_identical = bool(torch.equal(logits_ckpt, logits_sd))
    finite = bool(torch.isfinite(logits_ckpt).all())
    del reference, at_save, logits_ckpt, logits_sd
    free_cuda()

    launches = {name: path_launches[name] + after_load[name]
                + fresh_launches[name] + serve_launches[name]
                for name in path_launches}
    gb = nbytes / 1e9
    emit({"phase": "checkpoint", "model": "gpt2-1.3b", "tag": got_tag,
          "client_state": client, "tag_bytes": nbytes,
          "tag_files": sorted(manifest["files"]),
          "manifest_topology": manifest.get("topology"),
          "save_s": save_s, "save_gb_per_s": gb / save_s,
          "verify_s": verify_s, "verify_gb_per_s": gb / verify_s,
          "load_s": load_s, "load_gb_per_s": gb / load_s,
          "load_s_less_verify_s": load_s - verify_s,
          "fresh_engine_load_s": fresh_load_s,
          "serve_from_checkpoint_init_s": serve_init_s,
          "host_rss_gib_before_peak": {
              "save": [save_rss.before_gib, save_rss.peak_gib],
              "load": [load_rss.before_gib, load_rss.peak_gib],
              "fresh_engine_load": [fresh_rss.before_gib,
                                    fresh_rss.peak_gib]},
          "step_ms_before_save": before_ms,
          "step_ms_median_before_load": statistics.median(ms1),
          "step_ms_median_after_load": statistics.median(ms2),
          "step_ms_before_load": ms1, "step_ms_after_load": ms2,
          "losses": [float(x) for x in losses1],
          "same_engine": same_engine, "fresh_engine": fresh_engine,
          "state_at_save_restored": restored is None,
          "optimizer_count_after_load": count_after_load,
          "served_logits_identical": served_identical,
          "launches_after_load": after_load,
          "fresh_engine_launches": fresh_launches,
          "serve_launches": serve_launches, "launches": launches,
          "card": nvidia_smi_line()})
    bad = []
    if problems:
        bad.append(f"the saved tag fails verification: {problems}")
    if got_tag != tag or client != {"note": "chip_smoke"}:
        bad.append(f"load returned {got_tag!r}, {client!r}")
    if restored is not None or count_after_load != CKPT_STEPS_BEFORE:
        bad.append("the load did not restore the state at the save")
    if not (same_engine["losses_identical"]
            and same_engine["grad_norms_identical"]
            and same_engine["first_param_difference"] is None):
        bad.append("the steps after the load differ from those they repeat")
    if not same_engine["graphs_kept"]:
        bad.append("the load changed the engine's graphs")
    if not (fresh_tag == tag and fresh_engine["losses_identical"]
            and fresh_engine["grad_norms_identical"]
            and fresh_engine["first_param_difference"] is None):
        bad.append("the fresh engine's steps differ")
    for name, per in PER_STEP.items():
        if after_load[name] != per * CKPT_STEPS_AFTER:
            bad.append(f"{name}: {after_load[name]} launches in the "
                       f"{CKPT_STEPS_AFTER} steps after the load, want "
                       f"{per} x {CKPT_STEPS_AFTER}")
    if not (served_identical and finite):
        bad.append("the served logits differ from the state_dict's")
    if not all(np.isfinite([float(x) for x in losses1])):
        bad.append("non-finite loss")
    if bad:
        raise AssertionError(f"checkpoint: {bad}")
    return launches


def small_ckpt_engine(optimizer, dtype=None, **blocks):
    """A small GPT's engine on the card (2 layers, width 256)."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT, GPTConfig

    cfg = GPTConfig(vocab_size=512, n_positions=128, n_embd=256, n_layer=2,
                    n_head=4, dtype=dtype or torch.float32,
                    use_flash_attention=True)
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
              "steps_per_print": 10 ** 9, "optimizer": optimizer, **blocks}
    return deepspeed_tpu_torch.initialize(model=GPT(cfg), config=config,
                                          seed=5)[0]


def flip_byte(path, at):
    with open(path, "r+b") as f:
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 0xFF]))


def checkpoint_small():
    """The small-model checks of the ``checkpoint`` phase."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.runtime import checkpoint_engine as ce
    from deepspeed_tpu_torch.runtime import checkpoint_manifest as cm
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    rng = np.random.RandomState(8)
    batches = [{"input_ids": x, "labels": x}
               for x in rng.randint(0, 512, size=(2, 2, 128))]
    it = iter(RepeatingLoader(batches))
    fused = {"type": "FusedAdam", "params": {"lr": SMALL_LR}}
    on_b4 = {"tpu": {"use_pallas_optimizer": True}}
    line, bad = {"phase": "checkpoint_small"}, []

    # the async engine: a step between save and wait must not reach the file
    engine = small_ckpt_engine(fused, nebula={"enabled": True}, **on_b4)
    train_steps(engine, it, 4)
    path = os.path.join(CKPT_DIR, "async", "t", "model.pt")
    before = {k: v.clone() for k, v in engine.module.state_dict().items()}
    engine.checkpoint_engine.save({"module": engine.module.state_dict()}, path)
    train_steps(engine, it, 1)
    engine.checkpoint_engine.commit("t")
    on_disk = ce.load_torch_file(path)["module"]
    line["async"] = {
        "engine": type(engine.checkpoint_engine).__name__,
        "file_holds_pre_step_values": first_difference(
            {k: v.cpu() for k, v in before.items()}, on_disk) is None,
        "step_moved_params": first_difference(
            before, engine.module.state_dict()) is not None,
        "manifest_verifies": cm.verify_tag_dir(os.path.dirname(path)) == []}
    if not all(v for k, v in line["async"].items() if k != "engine"):
        bad.append(f"async: {line['async']}")
    del engine, before, on_disk

    # keep_n 2 over 4 saves, a flipped byte, a corrupt tag with no fallback
    engine = small_ckpt_engine(fused, checkpoint={"keep_n": 2}, **on_b4)
    save_dir = os.path.join(CKPT_DIR, "keep_n")
    tags = []
    for i in range(4):
        train_steps(engine, it, 1)
        engine.save_checkpoint(save_dir)
        tags.append(f"global_step{engine.global_steps}")
        mpath = cm.manifest_path(os.path.join(save_dir, tags[-1]))
        os.utime(mpath, (1_000_000 + i,) * 2)  # ordered commit times
    kept = sorted(d for d in os.listdir(save_dir)
                  if os.path.isdir(os.path.join(save_dir, d)))
    latest = cm.read_latest(save_dir)
    newest = os.path.join(save_dir, tags[-1], "mp_rank_00_model_states.pt")
    flip_byte(newest, os.path.getsize(newest) // 2)
    fallback_tag, _ = engine.load_checkpoint(save_dir)
    lonely_dir = os.path.join(CKPT_DIR, "lonely")
    engine.save_checkpoint(lonely_dir)
    lonely = os.path.join(lonely_dir, f"global_step{engine.global_steps}",
                          "mp_rank_00_model_states.pt")
    flip_byte(lonely, os.path.getsize(lonely) // 2)
    try:
        engine.load_checkpoint(lonely_dir)
        raised = None
    except RuntimeError as e:
        raised = str(e)[:300]
    line["retention"] = {"kept": kept, "latest": latest,
                         "flipped_byte_fell_back_to": fallback_tag,
                         "corrupt_without_fallback_raised": raised}
    if kept != sorted(tags[-2:]) or latest != tags[-1]:
        bad.append(f"keep_n: kept {kept}, latest {latest}, saved {tags}")
    if fallback_tag != tags[-2]:
        bad.append(f"flipped byte: loaded {fallback_tag}, want {tags[-2]}")
    if raised is None or "no previous valid tag" not in raised:
        bad.append(f"corrupt tag without fallback: {raised}")

    # set_lr under replay: lr 0 freezes the parameters, the next lr moves
    # them, and the graphs stay
    graphs = graphs_of(engine)
    frozen = {k: v.clone() for k, v in engine.module.state_dict().items()}
    engine.optimizer_adapter.param_groups[0]["lr"] = 0.0
    train_steps(engine, it, 2)
    still = first_difference(frozen, engine.module.state_dict()) is None
    engine.set_lr(SMALL_LR)
    train_steps(engine, it, 1)
    moved = first_difference(frozen, engine.module.state_dict()) is not None
    line["set_lr"] = {"lr0_froze": still, "next_lr_moved": moved,
                      "graphs_kept": same_graphs(graphs, graphs_of(engine), 3),
                      "get_lr": engine.get_lr()}
    if not (still and moved and line["set_lr"]["graphs_kept"]):
        bad.append(f"set_lr: {line['set_lr']}")
    del engine, frozen
    free_cuda()

    # LAMB, Adagrad and SGD, captured against uncaptured
    line["optimizers"] = {}
    for name, opt in (("lamb", {"type": "Lamb", "params": {
                            "lr": SMALL_LR, "weight_decay": 0.1}}),
                      ("adagrad", {"type": "Adagrad", "params": {"lr": 1e-2}}),
                      ("sgd_nesterov", {"type": "SGD", "params": {
                          "lr": 1e-2, "momentum": 0.9, "nesterov": True}})):
        check, launches, losses, _, _, _, _ = captured_against_eager(
            lambda: small_ckpt_engine(opt, dtype=torch.bfloat16), batches,
            CKPT_SMALL_STEPS)
        line["optimizers"][name] = {"identical": check["identical"],
                                    "losses": losses, "launches": launches}
        if not check["identical"]:
            bad.append(f"{name}: captured and eager steps differ: {check}")
        if (launches["flash_attention_fwd"] != 2 * CKPT_SMALL_STEPS
                or launches["fused_adamw"]):
            bad.append(f"{name}: launches {launches}")
    emit(line)
    free_cuda()
    if bad:
        raise AssertionError(f"checkpoint_small: {bad}")


def profile_step(engine, it, name, marks, per_step):
    """Where the card's time goes in one traced train step (a graph replay
    on a captured engine); ``marks`` maps each kernel to a substring of its
    name. The profiler's count of each kernel must equal ``per_step``
    (the cross-check of the launch counts). Returns ``{name: summary}``,
    with a list of ``problems``."""
    step, by_name, count = _trace(lambda: engine.train_batch(it))
    step["kernel_ms"] = {k: sum(ms for name, ms in by_name.items() if mark in name)
                         for k, mark in marks.items()}
    step["kernel_share_of_device"] = {
        k: v / step["device_ms"] for k, v in step["kernel_ms"].items()}
    step["kernel_launches_traced"] = {
        k: sum(n for name, n in count.items() if mark in name)
        for k, mark in marks.items()}
    step["copy_kernels_ms"] = sum(ms for name, ms in by_name.items()
                                  if "copy" in name)
    step["problems"] = [
        f"{k}: the trace saw {n} launches, want {per_step[k]}"
        for k, n in step["kernel_launches_traced"].items() if n != per_step[k]]
    emit({"phase": "profile", name: step})
    return {name: step}


# benchmarks/sparse_attention_bench.py:30-41 at its defaults (seq 4096,
# micro batch 1, :64-65), plus the device block that routes FusedAdam to B4
# (as GPT_PRETRAIN_CONFIG has) and the kernel selector that routes attention
# to B5-B7
BIGBIRD_BLOCK = {"mode": "bigbird", "block": 128, "num_random_blocks": 1,
                 "num_sliding_window_blocks": 3, "num_global_blocks": 1}
SPARSE_SEQ = 4096
BERT_SPARSE_CONFIG = {
    "train_micro_batch_size_per_gpu": 1,
    "gradient_accumulation_steps": 1,
    "bf16": {"enabled": True},
    "gradient_clipping": 1.0,
    "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-4}},
    "steps_per_print": 10 ** 9,
    "tpu": {"use_pallas_optimizer": True},
    "sparse_attention": dict(BIGBIRD_BLOCK, kernel="pallas"),
}
SPARSE_PER_STEP = {"block_sparse_fwd": 48, "block_sparse_dq": 24,
                   "block_sparse_dkv": 24, "fused_adamw": 1}
# the kernels against the gather and dense implementations on one step from
# the same weights and batch: the tolerances of the GPT flash/einsum check
# (bf16; the three round scores and probabilities at different points)
SPARSE_LOSS_REL_TOL = TRAIN_LOSS_REL_TOL
SPARSE_GNORM_REL_TOL = TRAIN_GNORM_REL_TOL
# the attention qkv weights' gradients, q, k and v rows apart, against the
# other implementations' (relative L2 over the 24 layers): the loss and the
# global norm barely see attention at random init, these rows see nothing
# else. A zeroed gradient (B6's dq, B7's dk or dv) reads 1.0. The kernels'
# q and k rows lie ~0.06 from dense and gather in bf16, against gather's
# ~0.013 from dense: the backward's delta = rowsum(o * do) from the rounded
# o (the flash formulation, as in the TPU kernels) accounts for ~0.055 of
# it on the plain f32 versions, and in f32 the routes agree to ~1e-5
# (sparse_grad_spread.py)
SPARSE_QKV_GRAD_REL_TOL = 0.15
# one repeated batch of 4096 tokens (about 600 labelled): the MLM loss must
# fall by at least 0.5 nat over the 10 steps at lr 1e-4
SPARSE_MIN_LOSS_DROP = 0.5
# timed steps of the gather and dense implementations, after their first
SPARSE_OTHER_STEPS = 3


def bert_flops_per_token(model, layout, block):
    """Training FLOPs per token of BERT under a block-sparse layout: 6 per
    weight of every matrix product (the Dense layers and the tied decoder)
    plus 3 x 4 per visible (query, key) pair per head dimension."""
    from deepspeed_tpu_torch.models.transformer_lm import Dense

    cfg = model.config
    weights = sum(m.weight.numel() for m in model.modules() if isinstance(m, Dense))
    weights += cfg.vocab_size * cfg.hidden_size
    pairs = visible_pairs(layout, block, cfg.num_attention_heads)
    attn = 12 * cfg.num_hidden_layers * pairs * cfg.head_dim / SPARSE_SEQ
    return 6.0 * weights + attn


def qkv_grads(model, batch):
    """The gradients of every attention ``qkv`` weight from one forward and
    backward of ``batch`` (no optimizer step), split into their q, k and v
    rows and concatenated over the layers, in f32."""
    import torch

    model.train()
    dev = next(model.parameters()).device
    loss = model(**{k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    loss.backward()
    rows = {"q": [], "k": [], "v": []}
    for name, p in model.named_parameters():
        if name.endswith("qkv.weight"):
            for part, g in zip(rows.values(), p.grad.float().chunk(3, dim=0)):
                part.append(g.flatten())
    model.zero_grad(set_to_none=True)
    return {n: torch.cat(parts) for n, parts in rows.items()}


def phase_sparse_train():
    """BERT-Large under BigBird at 4096 through initialize -> train_batch,
    the block-sparse slice's main path: one step each on the gather and
    dense implementations from the same weights (then the median of 3 more
    as their step time), then 12 captured steps on the kernels (B5-B7, B4;
    2 warm-up, 10 replays) against 12 uncaptured ones from the same seed.
    Returns the kernels' launch counts on the captured run."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import BertForPreTraining, bert_config

    cfg = bert_config("bert-large", dtype=torch.bfloat16, scan_layers=True,
                      remat=True, remat_policy="full",
                      max_position_embeddings=SPARSE_SEQ)

    def config(kernel):
        return dict(BERT_SPARSE_CONFIG,
                    sparse_attention=dict(BIGBIRD_BLOCK, kernel=kernel))

    free_cuda()
    t0 = time.perf_counter()
    first = bert_large_engine()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sc = first.module.config.sparse_attention
    batch = mlm_batch(1, SPARSE_SEQ)
    labels = batch["labels"]

    weights = {k: v.clone() for k, v in first.module.state_dict().items()}
    grads = qkv_grads(first.module, batch)
    layout = sc.make_layout(SPARSE_SEQ)
    fpt = bert_flops_per_token(first.module, layout, sc.block)
    n_params = sum(p.numel() for p in first.module.parameters())
    del first
    others, other_ms, qkv_err = {}, {}, {}
    for kernel in ("gather", "dense"):
        # a copy each: the engine takes the tensors it is given as its
        # parameters and trains them in place
        other, _, _, _ = deepspeed_tpu_torch.initialize(
            model=BertForPreTraining(cfg), config=config(kernel),
            model_parameters={k: v.clone() for k, v in weights.items()})
        qkv_err[kernel] = {n: float((grads[n] - g).norm() / g.norm())
                           for n, g in qkv_grads(other.module, batch).items()}
        others[kernel] = [float(other.train_batch(iter([batch]))),
                          other.get_global_grad_norm()]
        # then the implementation's step time (the first step above warmed
        # it; its later steps replay its captured step)
        other_ms[kernel] = wall_ms(lambda: other.train_batch(iter([batch])),
                                   reps=SPARSE_OTHER_STEPS)
        del other
        free_cuda()
    del weights, grads

    torch.cuda.reset_peak_memory_stats()
    traces = {}
    check, launches, losses, norms, times, e_losses, e_times = \
        captured_against_eager(
            bert_large_engine, [batch], STEPS,
            traced=lambda eng, it: traces.update(profile_step(
                eng, it, "sparse_train_step_bert_large",
                {"block_sparse_fwd": "sparse_fwd_",
                 "block_sparse_dq": "sparse_dq_",
                 "block_sparse_dkv": "sparse_dkv_",
                 "fused_adamw": "adamw_kernel"}, SPARSE_PER_STEP)))
    gnorm = norms[0]
    ms, eager_ms = step_medians(times, e_times)
    tflops = SPARSE_SEQ * fpt / ms / 1e9
    trace = traces["sparse_train_step_bert_large"]
    line = {"phase": "sparse_train", "model": "bert-large",
            "params": n_params,
            "config": BERT_SPARSE_CONFIG, "batch": [1, SPARSE_SEQ],
            "layout": type(sc).__name__, "active_tiles": int((layout[0] != 0).sum()),
            "labelled_tokens": int((labels != -100).sum()),
            "init_s": init_s, "losses": losses, "eager_losses": e_losses,
            "kernels_vs_gather_vs_dense": {
                "loss": [losses[0], others["gather"][0], others["dense"][0]],
                "grad_norm": [gnorm, others["gather"][1], others["dense"][1]],
                "qkv_grad_rel_l2": qkv_err,
                "qkv_grad_rel_tol": SPARSE_QKV_GRAD_REL_TOL},
            "captured_vs_eager": check,
            "launches": launches, "steps": STEPS,
            "capture_warmup_steps": CAPTURE_WARMUP,
            "step_ms_median": ms, "step_ms": times,
            "eager_step_ms_median": eager_ms, "eager_step_ms": e_times,
            "capture_step_ms": times[CAPTURE_WARMUP],
            "traced_replay_device_busy_share": trace["device_busy_share"],
            "gather_step_ms_median": other_ms["gather"],
            "dense_step_ms_median": other_ms["dense"],
            "tokens_per_s": SPARSE_SEQ / ms * 1e3,
            "model_flops_per_token": fpt, "model_tflops_per_s": tflops,
            "mfu_vs_989": tflops / 989.0,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(line)
    problems = []
    if not all(np.isfinite(losses)):
        problems.append("non-finite loss")
    if not losses[-1] <= losses[0] - SPARSE_MIN_LOSS_DROP:
        problems.append(f"loss did not fall by {SPARSE_MIN_LOSS_DROP}")
    for name, per in SPARSE_PER_STEP.items():
        if launches[name] != per * STEPS:
            problems.append(f"{name}: {launches[name]} launches, want "
                            f"{per} x {STEPS}")
    for kernel, (loss_o, gnorm_o) in others.items():
        if abs(losses[0] - loss_o) > SPARSE_LOSS_REL_TOL * abs(loss_o):
            problems.append(f"kernel and {kernel} losses disagree")
        if abs(gnorm - gnorm_o) > SPARSE_GNORM_REL_TOL * abs(gnorm_o):
            problems.append(f"kernel and {kernel} grad norms disagree")
        for n, err in qkv_err[kernel].items():
            if not err <= SPARSE_QKV_GRAD_REL_TOL:
                problems.append(f"kernel and {kernel} {n} gradients disagree")
    if not check["identical"]:
        problems.append("captured and eager steps differ")
    problems += trace["problems"]
    if problems:
        raise AssertionError(f"sparse_train: {problems}")
    return launches


# a small fp16 GPT whose loss scale starts far too high: its gradients
# overflow until the scale has halved enough, past the capture's warm-up
# steps, so replayed steps are skipped too
SMALL_FP16_SCALE_POWER = 26
SMALL_CAPTURE_STEPS = 16


def phase_small_capture():
    """Captured steps against uncaptured ones on small models: fp16 with
    dynamic loss scaling whose replayed steps overflow (each skipped step
    must halve the scale and keep the optimizer's count), and gradient
    accumulation 2 (the micro-step and apply graphs). Losses, grad norms,
    loss scales, counts and parameters must be identical."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT, GPTConfig

    rng = np.random.RandomState(6)
    batches = [{"input_ids": x, "labels": x}
               for x in rng.randint(0, 512, size=(2, 2, 128))]
    base = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
            "optimizer": {"type": "FusedAdam",
                          "params": {"lr": SMALL_LR, "weight_decay": 0.1}},
            "steps_per_print": 10 ** 9, "tpu": {"use_pallas_optimizer": True}}
    runs = {
        "fp16_overflow": (torch.float16, dict(base, fp16={
            "enabled": True, "initial_scale_power": SMALL_FP16_SCALE_POWER,
            "hysteresis": 1}), SMALL_CAPTURE_STEPS),
        "bf16_gas2": (torch.bfloat16, dict(base, bf16={"enabled": True},
                                           gradient_accumulation_steps=2), 8),
    }
    problems = []
    for name, (dtype, config, steps) in runs.items():
        cfg = GPTConfig(vocab_size=512, n_positions=128, n_embd=256,
                        n_layer=2, n_head=4, dtype=dtype,
                        use_flash_attention=True)
        history = []

        def make_engine():
            eng = deepspeed_tpu_torch.initialize(model=GPT(cfg), config=config,
                                                 seed=5)[0]
            history.append([])
            real = eng._train_batch

            def logged(it, eager=False):
                out = real(it, eager=eager)
                history[-1].append((eng.loss_scale, eng.skipped_steps,
                                    eng.optimizer.count))
                return out

            eng._train_batch = logged
            return eng

        check, launches, losses, _, times, e_losses, _ = captured_against_eager(
            make_engine, batches, steps)
        captured, eager = history
        gas = config.get("gradient_accumulation_steps", 1)
        want = {"flash_attention_fwd": cfg.n_layer * gas * steps,
                "flash_attention_bwd_dq": cfg.n_layer * gas * steps,
                "flash_attention_bwd_dkv": cfg.n_layer * gas * steps,
                "fused_adamw": steps, "block_sparse_fwd": 0,
                "block_sparse_dq": 0, "block_sparse_dkv": 0, **UNSEGMENTED}
        # (scale, skipped, count) after each step, from the start
        prev = (2.0 ** SMALL_FP16_SCALE_POWER if dtype == torch.float16
                else 1.0, 0, 0)
        skipped_replays = updated_replays = 0
        for i, now in enumerate(captured):
            skipped = now[1] > prev[1]
            if skipped and not (now[0] == prev[0] / 2 and now[2] == prev[2]):
                problems.append(f"{name} step {i}: skipped without halving "
                                f"the scale and keeping the count")
            if not skipped and now[2] != prev[2] + 1:
                problems.append(f"{name} step {i}: updated without a count")
            if i >= CAPTURE_WARMUP:
                skipped_replays += skipped
                updated_replays += not skipped
            prev = now
        emit({"phase": "small_capture", "run": name, "steps": steps,
              "gas": gas, "captured_vs_eager": check,
              "scale_skipped_count_by_step": captured,
              "eager_scale_skipped_count_by_step": eager,
              "skipped_replays": skipped_replays,
              "updated_replays": updated_replays,
              "losses": losses, "eager_losses": e_losses,
              "launches": launches, "step_ms": times})
        if not check["identical"] or captured != eager:
            problems.append(f"{name}: captured and eager steps differ")
        if launches != want:
            problems.append(f"{name}: launches {launches}, want {want}")
        if dtype == torch.float16 and not (skipped_replays and updated_replays):
            problems.append(f"{name}: the replays did not both skip and update")
    if problems:
        raise AssertionError(f"small_capture: {problems}")


# ---------------------------------------------------------------------------
# data: GPT-2 1.3B trained on packed documents through the data pipeline
# ---------------------------------------------------------------------------
DATA_DOCS = 3000
DATA_MIN_LEN, DATA_MAX_LEN = 32, 1024
# past seq_length 1024: the packer cuts them
DATA_LONG_DOCS = (1100, 1536, 2048)
DATA_PIPELINE = {"enabled": True, "seq_length": 1024, "pack_sequences": True,
                 "prefetch": True, "prefetch_depth": 2, "seed": 0}
# fixed_linear from 256 to 1024 in steps of 256: the lengths stay multiples
# of 128, so every step takes the flash kernels (the model's gate). Over 12
# curriculum steps each length lasts 4 steps: 2 warm-ups, the capture and a
# replay (over 8, 768 would last only 2 steps and never be captured)
DATA_CURRICULUM = {"enabled": True, "curriculum_type": "seqlen",
                   "min_difficulty": 256, "max_difficulty": 1024,
                   "schedule_type": "fixed_linear",
                   "schedule_config": {"total_curriculum_step": 12,
                                       "difficulty_step": 256}}
DATA_CURRICULUM_STEPS = 16
# the packed step on the flash kernels against the einsum path with the
# segment mask: the train phase's flash-against-einsum bounds (bf16)
PACKED_LOSS_REL_TOL = TRAIN_LOSS_REL_TOL
PACKED_GNORM_REL_TOL = TRAIN_GNORM_REL_TOL
# how long a prefetch copy waits for a capture to begin (the curriculum
# run's proof that the worker copies while a graph is captured)
CAPTURE_COPY_WAIT_S = 0.3
DATA_DIR = os.path.join("build", "chip_smoke_data")
DATA_RESUME_SAVE, DATA_RESUME_STEPS = 4, 8


def data_corpus(vocab, n=DATA_DOCS, seed=0, lo=DATA_MIN_LEN, hi=DATA_MAX_LEN,
                long_docs=DATA_LONG_DOCS):
    """``n`` documents from ``seed``: lengths log-uniform in [lo, hi] (most
    documents short, as in web text, so that rows hold several), a few of
    ``long_docs`` tokens; tokens in [1, vocab) drawn from a Zipf
    distribution (p ~ 1 / rank), so that a few steps can learn something
    and the loss falls."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lengths = np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.int64)
    lengths[rng.choice(n, len(long_docs), replace=False)] = long_docs
    p = 1.0 / np.arange(1, vocab)
    tokens = rng.choice(vocab - 1, size=int(lengths.sum()), p=p / p.sum()) + 1
    return np.split(tokens.astype(np.int32), np.cumsum(lengths)[:-1])


class BatchTap:
    """The data iterator a run hands ``train_batch``: for every batch drawn
    it keeps, on the card (no host read), copies of the token and segment
    ids. A batch the prefetch worker placed is waited for first."""

    def __init__(self, it):
        self.it, self.ids, self.segment_ids = it, [], []

    def __iter__(self):
        return self

    def __next__(self):
        import torch

        from deepspeed_tpu_torch.data.prefetch import PlacedBatch

        batch = next(self.it)
        if isinstance(batch, PlacedBatch):
            batch.wait()
        self.ids.append(torch.as_tensor(batch["input_ids"]).clone())
        self.segment_ids.append(torch.as_tensor(batch["segment_ids"]).clone())
        return batch

    def summary(self):
        """Per batch: the largest segment count of a row, and the length."""
        return ([int(s.max()) for s in self.segment_ids],
                [int(x.shape[1]) for x in self.ids])


def data_engine(pipeline=None, curriculum=None, seed=0, flash=True):
    """GPT-2 1.3B through ``initialize`` with ``GPT_PRETRAIN_CONFIG``, the
    data pipeline (``DATA_PIPELINE`` updated by ``pipeline``) and the
    corpus; returns the engine and its loader."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT, gpt2_config

    config = dict(GPT_PRETRAIN_CONFIG,
                  data_pipeline=dict(DATA_PIPELINE, **(pipeline or {})))
    if curriculum is not None:
        config["curriculum_learning"] = curriculum
    model = GPT(gpt2_config(
        "gpt2-1.3b", n_positions=1024, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, remat=True, remat_policy="full",
        use_flash_attention=flash))
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=model, config=config, seed=seed,
        training_data=data_corpus(model.config.vocab_size))
    return engine, loader


def data_run(steps, eager=False, pipeline=None, curriculum=None,
             on_engine=None, traced=None):
    """``steps`` fenced ``train_batch`` steps of a fresh ``data_engine``
    (``eager``: the step functions uncaptured) over its own loader. Counts
    are set to 0 just before the steps; ``on_engine(engine)`` runs first,
    ``traced(engine, data_iter)`` after the steps and the parameters' copy.
    Returns the run's record (losses, grad norms, host ms, launches in all
    and per step, the graphs, the prefetch counters, the batches' lengths
    and segment counts, peak memory) and a copy of the final parameters;
    the engine is stopped and freed."""
    import torch

    engine, loader = data_engine(pipeline, curriculum)
    if on_engine is not None:
        on_engine(engine)
    tap = BatchTap(iter(loader))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, norms, times, per_step = [], [], [], []
    for _ in range(steps):
        before = read_launches()
        loss, norm, ms = train_steps(engine, tap, 1, eager=eager)
        after = read_launches()
        losses += loss
        norms += norm
        times += ms
        per_step.append({k: after[k] - before[k] for k in after})
    run = {"launches": read_launches(), "launches_by_step": per_step,
           "losses": [float(x) for x in losses], "norm_tensors": norms,
           "step_ms": times,
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "graphs": [[list(shape) for name, shape, _ in key[1]
                       if name == "input_ids"][0]
                      for key in engine._fused.graphs],
           "counters": (loader.counters() if hasattr(loader, "counters")
                        else None)}
    run["max_segments"], run["lengths"] = tap.summary()
    params = {k: v.clone() for k, v in engine.params.items()}
    if traced is not None:
        traced(engine, tap)
    engine.destroy()
    del engine, loader, tap
    free_cuda()
    return run, params


DATA_UNFENCED_STEPS = 20


def data_unfenced_ms(prefetch):
    """Mean ms per step of ``DATA_UNFENCED_STEPS`` replays of a fresh
    ``data_engine`` with one fence before and one after them (a training
    loop's rate: the host runs ahead of the card), after the capture's 3
    fenced steps; ``prefetch`` on or off."""
    import torch

    engine, loader = data_engine({"prefetch": prefetch})
    it = iter(loader)
    train_steps(engine, it, CAPTURE_WARMUP + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DATA_UNFENCED_STEPS):
        engine.train_batch(it)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / DATA_UNFENCED_STEPS
    engine.destroy()
    del engine, loader, it
    free_cuda()
    return ms


def data_host_costs(n=24):
    """The host's work per packed 1.3B batch, on this thread alone (median
    ms over ``n`` batches): packing (the pipeline's ``next``), the deep copy
    of its state that the prefetcher takes with each batch, and the
    transfer the worker runs (int64 tensors, pinned, copied on a stream of
    their own, to the copy's end)."""
    import copy

    import torch

    from deepspeed_tpu_torch.data import PackedDataPipeline
    from deepspeed_tpu_torch.data.prefetch import CopyStream

    pipe = PackedDataPipeline(data_corpus(50257), batch_size=4,
                              seq_length=1024, seed=0)
    put = CopyStream("cuda")
    stages = {"pack_ms": [], "state_copy_ms": [], "transfer_ms": []}
    for _ in range(n):
        t0 = time.perf_counter()
        batch = next(pipe)
        t1 = time.perf_counter()
        copy.deepcopy(pipe.state_dict())
        t2 = time.perf_counter()
        placed = put({k: torch.as_tensor(v).long() for k, v in batch.items()})
        placed.event.synchronize()
        t3 = time.perf_counter()
        for key, a, b in (("pack_ms", t0, t1), ("state_copy_ms", t1, t2),
                          ("transfer_ms", t2, t3)):
            stages[key].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in stages.items()}


def distinct_nonzero(counts):
    """The distinct dicts of a list, each without its zero entries."""
    out = []
    for c in counts:
        c = {k: v for k, v in c.items() if v}
        if c not in out:
            out.append(c)
    return out


def data_compare(a, a_params, b, b_params):
    """Whether two runs agree bit for bit: losses, grad norms and final
    parameters."""
    diff = first_difference(a_params, b_params)
    return {"losses_identical": a["losses"] == b["losses"],
            "grad_norms_identical": identical(a["norm_tensors"],
                                              b["norm_tensors"]),
            "params_identical": diff is None, "first_param_difference": diff}


def packed_exactness(cfg=None, batch_size=4, seq_length=1024):
    """One packed batch (the pipeline's first) of ``cfg`` (default: GPT-2
    1.3B as in ``train``) through the flash kernels' segment variant and
    through the einsum path with the segment mask, the same weights
    (shared): loss and grad norm. Then per-token losses under the flash
    path, before and after the tokens of one document are changed: every
    other document's must stay bit for bit (a masked score contributes
    exp(NEG_INF - m) = 0)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.data import PackedDataPipeline
    from deepspeed_tpu_torch.models.transformer_lm import (GPT, _shifted_targets,
                                                           gpt2_config,
                                                           materialize_gpt)

    if cfg is None:
        cfg = gpt2_config("gpt2-1.3b", n_positions=1024,
                          dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                          remat=True, remat_policy="full",
                          use_flash_attention=True)
    flash = GPT(cfg)
    materialize_gpt(flash, "cuda", torch.Generator("cuda").manual_seed(0))
    einsum = GPT(dataclasses.replace(cfg, use_flash_attention=False))
    materialize_gpt(einsum, "cuda", None, state_dict=flash.state_dict())
    host = next(PackedDataPipeline(data_corpus(cfg.vocab_size),
                                   batch_size=batch_size,
                                   seq_length=seq_length, seed=0))
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in host.items()}

    def loss_and_norm(model):
        model.train()
        for p in model.parameters():
            p.grad = None
        loss = model(**batch)
        loss.backward()
        norm = torch.sqrt(sum((p.grad.float() ** 2).sum()
                              for p in model.parameters()))
        for p in model.parameters():
            p.grad = None
        return float(loss.detach()), float(norm)

    reset_launches()
    loss_f, norm_f = loss_and_norm(flash)
    seg_launches = {k: v for k, v in read_launches().items()
                    if k.startswith("flash")}
    loss_e, norm_e = loss_and_norm(einsum)

    @torch.no_grad()
    def per_token(ids):
        flash.eval()
        logits = flash(ids, segment_ids=batch["segment_ids"],
                       positions=batch["positions"])
        targets, w = _shifted_targets(ids, None, batch["segment_ids"])
        ce = F.cross_entropy(logits.view(-1, logits.shape[-1]),
                             targets.reshape(-1), reduction="none")
        return ce.view(ids.shape), w

    base, w = per_token(batch["input_ids"])
    seg = batch["segment_ids"]
    counts = seg.amax(dim=1).tolist()
    row = int(np.argmax(counts))
    doc = (max(counts) + 1) // 2  # a document in the middle of the row
    changed = torch.zeros_like(seg, dtype=torch.bool)
    changed[row] = seg[row] == doc
    ids = batch["input_ids"].clone()
    ids[changed] = (ids[changed] * 7 + 3) % (cfg.vocab_size - 1) + 1
    after, _ = per_token(ids)
    keep = (w > 0) & ~changed
    diff = (after - base).abs()
    out = {"batch_segments_per_row": counts,
           "tolerance": {"loss_rel": PACKED_LOSS_REL_TOL,
                         "grad_norm_rel": PACKED_GNORM_REL_TOL},
           "flash": {"loss": loss_f, "grad_norm": norm_f},
           "einsum": {"loss": loss_e, "grad_norm": norm_e},
           "loss_rel_err": abs(loss_f - loss_e) / abs(loss_e),
           "grad_norm_rel_err": abs(norm_f - norm_e) / abs(norm_e),
           "flash_launches": seg_launches,
           "isolation": {"row": row, "document": doc,
                         "changed_tokens": int(changed.sum()),
                         "other_tokens": int(keep.sum()),
                         "other_max_abs_diff": float(diff[keep].max()),
                         "other_bit_identical": bool(
                             torch.equal(after[keep], base[keep])),
                         "changed_max_abs_diff": float(
                             diff[changed & (w > 0)].max())}}
    out["segment_ids"] = batch["segment_ids"].cpu()
    del flash, einsum, batch
    free_cuda()
    return out


def segment_kernel_times(segment_ids):
    """B1, B2 and B3 at GPT-2 1.3B's attention shape [4, 1024, 16, 128],
    bf16, causal, under a packed batch's segment ids and without them, in
    turns (without, with, with, without), by device time; the segment
    variant's outputs against its plain version (``TOLERANCE``,
    ``GRAD_REL_TOL``); its bound counts the pairs the segments leave
    visible."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    b, t, h, d = segment_ids.shape[0], segment_ids.shape[1], 16, 128
    gen = torch.Generator().manual_seed(40)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen).to("cuda",
                                                            torch.bfloat16)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    do = torch.randn((b, t, h, d), generator=gen).to("cuda", torch.bfloat16)
    seg = segment_ids.to("cuda", torch.int32).contiguous()
    scale = d ** -0.5
    calls = {}
    for name, s_ids in (("plain", None), ("segment", seg)):
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True,
                                        segment_ids=s_ids)
        delta = fa.bwd_delta(o, do)
        calls[name] = {
            "flash_attention_fwd":
                lambda s_ids=s_ids: fa._launch(q, k, v, s_ids, True, scale),
            "flash_attention_bwd_dq":
                lambda s_ids=s_ids, lse=lse, delta=delta: fa._launch_dq(
                    q, k, v, lse, delta, do, s_ids, True, scale),
            "flash_attention_bwd_dkv":
                lambda s_ids=s_ids, lse=lse, delta=delta: fa._launch_dkv(
                    q, k, v, lse, delta, do, s_ids, True, scale)}
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)
    o_ref, _ = fa.flash_attention_reference(q, k, v, causal=True,
                                            segment_ids=seg)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                   segment_ids=seg)
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                 causal=True, segment_ids=seg)
    errs = {"o_max_abs": float((o.float() - o_ref.float()).abs().max()),
            "grad_rel": max(_rel_err(g, w) for g, w in zip(grads, want))}
    sizes = [torch.bincount(row[row > 0].long()).tolist() for row in seg.cpu()]
    pairs = sum(n * (n + 1) // 2 for row in sizes for n in row)
    flops_per_pair = {"flash_attention_fwd": 4, "flash_attention_bwd_dq": 6,
                      "flash_attention_bwd_dkv": 8}
    out = {"shape": [b, t, h, d], "visible_pairs_per_head": pairs,
           "causal_pairs_per_head": b * t * (t + 1) // 2, "errors": errs,
           "tolerance": {"o_max_abs": TOLERANCE["bfloat16"]["o"],
                         "grad_rel": GRAD_REL_TOL["bfloat16"]}}
    for kern, per_pair in flops_per_pair.items():
        times = {"plain": [], "segment": []}
        for who in ("plain", "segment", "segment", "plain"):
            times[who].append(device_ms(calls[who][kern])["ms"])
        bound, by = _bound(per_pair * pairs * h * d, 0, "bfloat16")
        out[kern] = {"ms": statistics.mean(times["segment"]),
                     "unsegmented_ms": statistics.mean(times["plain"]),
                     "ms_by_turn": times, "segment_bound_ms": bound}
    del q, k, v, qkv, do, o, lse, grads, want, calls
    free_cuda()
    return out


class CaptureCopies:
    """Wraps an engine's prefetch transfer: each copy first waits up to
    ``CAPTURE_COPY_WAIT_S`` for a graph capture to be under way, and counts
    the copies made while one was (the worker's copies must not break a
    capture nor land in its graph)."""

    def __init__(self, engine):
        from deepspeed_tpu_torch.runtime import compiled_step

        self.capturing = compiled_step.capturing
        self.put = engine._prefetch_put
        self.during, self.total = 0, 0
        engine.training_dataloader.put_fn = self

    def __call__(self, batch):
        deadline = time.monotonic() + CAPTURE_COPY_WAIT_S
        while not self.capturing() and time.monotonic() < deadline:
            time.sleep(0.001)
        out = self.put(batch)
        self.total += 1
        self.during += self.capturing()
        return out


def data_resume():
    """A small GPT on the packed pipeline, prefetch on: 8 steps with a save
    after 4, then a fresh engine (another seed's weights) loads the tag and
    takes 4 steps: its batches must be the first run's last 4, token for
    token, and its losses the same bit for bit."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT, GPTConfig

    def make(seed):
        cfg = GPTConfig(vocab_size=512, n_positions=256, n_embd=256,
                        n_layer=2, n_head=4, dtype=torch.bfloat16,
                        use_flash_attention=True)
        config = {"train_micro_batch_size_per_gpu": 4,
                  "gradient_clipping": 1.0, "bf16": {"enabled": True},
                  "optimizer": {"type": "FusedAdam",
                                "params": {"lr": SMALL_LR}},
                  "tpu": {"use_pallas_optimizer": True},
                  "steps_per_print": 10 ** 9,
                  "data_pipeline": dict(DATA_PIPELINE, seq_length=256)}
        return deepspeed_tpu_torch.initialize(
            model=GPT(cfg), config=config, seed=seed,
            training_data=data_corpus(512, n=400, lo=8, hi=256,
                                      long_docs=(300,)))

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    try:
        engine, _, loader, _ = make(5)
        tap = BatchTap(iter(loader))
        losses = []
        for i in range(DATA_RESUME_STEPS):
            losses.append(float(engine.train_batch(tap)))
            if i + 1 == DATA_RESUME_SAVE:
                engine.save_checkpoint(DATA_DIR)
        engine.destroy()
        fresh, _, loader2, _ = make(6)
        fresh.load_checkpoint(DATA_DIR)
        tap2 = BatchTap(iter(loader2))
        resumed = [float(fresh.train_batch(tap2))
                   for _ in range(DATA_RESUME_STEPS - DATA_RESUME_SAVE)]
        fresh.destroy()
        same_ids = [bool(torch.equal(a, b))
                    for a, b in zip(tap.ids[DATA_RESUME_SAVE:], tap2.ids)]
        out = {"losses": losses, "resumed_losses": resumed,
               "losses_identical": resumed == losses[DATA_RESUME_SAVE:],
               "batches_token_identical": same_ids,
               "max_segments": tap.summary()[0]}
        del engine, fresh, loader, loader2, tap, tap2
        free_cuda()
        return out
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)


def phase_data():
    """GPT-2 1.3B on packed documents through ``initialize(...,
    training_data=docs)`` with a ``data_pipeline`` block, the data slice's
    main path: 12 captured steps with prefetch (counts set to 0 just before
    them) against 12 uncaptured ones and 12 captured ones without
    prefetch; the packed batch on the flash kernels against the einsum
    path, per-document isolation; the curriculum; a resume. Returns the
    kernels' launch counts on the captured prefetch run."""
    free_cuda()
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    traces = {}
    main, main_params = data_run(
        STEPS, traced=lambda eng, it: traces.update(profile_step(
            eng, it, "data_step_1p3b",
            {"flash_attention_fwd": "flash_fwd_",
             "flash_attention_bwd_dq": "bwd_dq_",
             "flash_attention_bwd_dkv": "bwd_dkv_",
             "fused_adamw": "adamw_kernel"}, PER_STEP)))
    eager, eager_params = data_run(STEPS, eager=True)
    vs_eager = data_compare(main, main_params, eager, eager_params)
    del eager_params
    off, off_params = data_run(STEPS, pipeline={"prefetch": False})
    vs_off = data_compare(main, main_params, off, off_params)
    del main_params, off_params
    free_cuda()
    exact = packed_exactness()
    copies = {}
    curr, curr_params = data_run(
        DATA_CURRICULUM_STEPS, curriculum=DATA_CURRICULUM,
        on_engine=lambda eng: copies.update(tap=CaptureCopies(eng)))
    curr_eager, curr_eager_params = data_run(
        DATA_CURRICULUM_STEPS, eager=True, curriculum=DATA_CURRICULUM)
    vs_curr = data_compare(curr, curr_params, curr_eager, curr_eager_params)
    del curr_params, curr_eager_params
    free_cuda()
    resume = data_resume()
    kernels = segment_kernel_times(exact.pop("segment_ids"))
    host = data_host_costs()
    unfenced = {"on": [], "off": []}
    for prefetch in (True, False, False, True):
        unfenced["on" if prefetch else "off"].append(
            data_unfenced_ms(prefetch))
    ms, eager_ms = step_medians(main["step_ms"], eager["step_ms"])
    off_ms = statistics.median(off["step_ms"][CAPTURE_WARMUP + 1:])
    lengths = sorted(set(curr["lengths"]))
    line = {"phase": "data", "card": smi, "model": "gpt2-1.3b",
            "config": dict(GPT_PRETRAIN_CONFIG, data_pipeline=DATA_PIPELINE),
            "corpus": {"documents": DATA_DOCS,
                       "lengths": [DATA_MIN_LEN, DATA_MAX_LEN],
                       "long": list(DATA_LONG_DOCS)},
            "steps": STEPS, "capture_warmup_steps": CAPTURE_WARMUP,
            "losses": main["losses"], "eager_losses": eager["losses"],
            "captured_vs_eager": vs_eager,
            "prefetch_off_losses": off["losses"],
            "prefetch_on_vs_off": vs_off,
            "launches": main["launches"],
            "launches_per_step": main["launches_by_step"][-1],
            "max_segments_per_row_by_batch": main["max_segments"],
            "step_ms_median": ms, "eager_step_ms_median": eager_ms,
            "prefetch_off_step_ms_median": off_ms,
            "step_ms": main["step_ms"], "prefetch_off_step_ms": off["step_ms"],
            "prefetch_counters": main["counters"],
            "traced_replay_device_busy_share":
                traces["data_step_1p3b"]["device_busy_share"],
            "unfenced_ms_per_step_by_turn": unfenced,
            "unfenced_steps": DATA_UNFENCED_STEPS,
            "host_ms_per_batch": host,
            "peak_allocated_gb": main["peak_allocated_gb"],
            "packed_exactness": exact,
            "curriculum": {
                "config": DATA_CURRICULUM, "steps": DATA_CURRICULUM_STEPS,
                "lengths_by_step": curr["lengths"],
                "distinct_lengths": lengths, "graphs": curr["graphs"],
                "losses": curr["losses"], "eager_losses": curr_eager["losses"],
                "captured_vs_eager": vs_curr,
                "launches_per_step_distinct": distinct_nonzero(
                    curr["launches_by_step"]),
                "peak_allocated_gb": curr["peak_allocated_gb"],
                "peak_reserved_gb": curr["peak_reserved_gb"],
                "step_ms": curr["step_ms"],
                "copies_during_a_capture": copies["tap"].during,
                "copies": copies["tap"].total,
                "prefetch_counters": curr["counters"]},
            "resume": resume, "segment_kernels": kernels,
            "seconds": time.perf_counter() - t0}
    emit(line)
    problems = []
    if not all(math.isfinite(x) for x in main["losses"]):
        problems.append("non-finite loss")
    if not main["losses"][-1] < main["losses"][0]:
        problems.append("the loss did not fall")
    if not all(v for k, v in vs_eager.items() if k.endswith("identical")):
        problems.append(f"captured against eager: {vs_eager}")
    if not all(v for k, v in vs_off.items() if k.endswith("identical")):
        problems.append(f"prefetch on against off: {vs_off}")
    problems += traces["data_step_1p3b"]["problems"]
    if not all(n > 1 for n in main["max_segments"]):
        problems.append("a batch with one document per row")
    want = dict(PER_STEP, **{k + "_segment": v for k, v in PER_STEP.items()
                             if k.startswith("flash")})
    for name, per in want.items():
        if main["launches"][name] != per * STEPS:
            problems.append(f"{name}: {main['launches'][name]} launches, "
                            f"want {per} x {STEPS}")
    if not (exact["loss_rel_err"] <= PACKED_LOSS_REL_TOL
            and exact["grad_norm_rel_err"] <= PACKED_GNORM_REL_TOL):
        problems.append("packed flash against einsum")
    if exact["flash_launches"]["flash_attention_fwd_segment"] == 0:
        problems.append("the exactness check missed the segment variant")
    if not exact["isolation"]["other_bit_identical"]:
        problems.append(f"isolation: {exact['isolation']}")
    if not exact["isolation"]["changed_max_abs_diff"] > 0:
        problems.append("isolation: the changed document's losses did not "
                        "change")
    if len(curr["graphs"]) != len(lengths) or len(lengths) < 4:
        problems.append(f"curriculum: {len(curr['graphs'])} graphs for "
                        f"lengths {lengths}")
    if not all(v for k, v in vs_curr.items() if k.endswith("identical")):
        problems.append(f"curriculum captured against eager: {vs_curr}")
    for i, got in enumerate(curr["launches_by_step"]):
        if any(got[name] != per for name, per in want.items()):
            problems.append(f"curriculum step {i + 1} launched {got}")
            break
    if not copies["tap"].during:
        problems.append("no prefetch copy ran during a capture")
    if not (kernels["errors"]["o_max_abs"] <= TOLERANCE["bfloat16"]["o"]
            and kernels["errors"]["grad_rel"] <= GRAD_REL_TOL["bfloat16"]):
        problems.append(f"segment variant at the packed shape: "
                        f"{kernels['errors']}")
    if not (resume["losses_identical"]
            and all(resume["batches_token_identical"])
            and len(resume["batches_token_identical"])
            == DATA_RESUME_STEPS - DATA_RESUME_SAVE):
        problems.append(f"resume: {resume}")
    if problems:
        raise AssertionError(f"data: {problems}")
    return main["launches"], kernels



# Mistral-7B-v0.1 (https://huggingface.co/mistralai/Mistral-7B-v0.1/blob/
# main/config.json) as deepspeed_tpu/module_inject/hf.py:516-537
# (llama_from_hf) configures it, with n_positions cut to its 4096-token
# sliding window: the JAX policy ignores the window, so 4096 is the longest
# context at which both packages compute Mistral's own attention
MISTRAL_7B = dict(vocab_size=32000, n_positions=4096, n_embd=4096,
                  n_layer=32, n_head=32, n_kv_head=8, intermediate_size=14336,
                  layer_norm_epsilon=1e-5, norm="rmsnorm", activation="silu",
                  gated_mlp=True, use_bias=False, attn_bias=False,
                  rotary=True, rope_theta=10000.0, learned_positions=False,
                  tie_word_embeddings=False)
MISTRAL_SOURCE = ("https://huggingface.co/mistralai/Mistral-7B-v0.1/blob/"
                  "main/config.json")
MISTRAL_SEQ = 4096
# serving's depth cut (PERF.md section 4): the serving phase serves all 32
# layers (int8, through the scheduler), and every check here is per layer
# or on the stack's output
MISTRAL_SERVE_LAYERS = 8
# training keeps the full width and cuts the depth: ZeRO-1 bf16 holds ~12
# bytes per parameter, 2.01 B parameters at 8 layers (~24 GB, and the
# eager twin of captured_against_eager after it); every layer is alike
MISTRAL_TRAIN_LAYERS = 8
MISTRAL_MICRO = 2
MISTRAL_PER_STEP = {"flash_attention_fwd": 2 * MISTRAL_TRAIN_LAYERS,
                    "flash_attention_bwd_dq": MISTRAL_TRAIN_LAYERS,
                    "flash_attention_bwd_dkv": MISTRAL_TRAIN_LAYERS,
                    "fused_adamw": 1}
# flash (f32 scores) against einsum (bf16 scores) on the same weights: each
# layer's attention output differs by bf16 rounding (2^-8 relative, ~4e-3);
# over 32 layers of a residual stream that adds up in quadrature to about
# sqrt(32) * 4e-3 = 2.3e-2 of the logits; the bound is twice that. The
# same bound holds cached decode against the full forward (the grouped
# decode contraction against the repeated einsum, other matmul shapes and
# the same bf16 rounding points)
MISTRAL_LOGITS_REL_L2 = 5e-2
# ragged left-padded serving prompts, up to the 512 of the prompt width
MISTRAL_PROMPT_LENGTHS = (37, 128, 300, 512)
MISTRAL_NEW_TOKENS = 32
# decode steps held logit for logit: captured graph against eager, and the
# cache against the full forward
MISTRAL_LOGIT_STEPS = 8
# the kernels' plain versions hold [T, T] f32 scores per head: they run on
# a slice (batch 1, heads 0-7) of the kernels' full-shape outputs
MISTRAL_PLAIN_SLICE = (1, 8)


def mistral_config(**over):
    import torch

    from deepspeed_tpu_torch.models.transformer_lm import GPTConfig

    fields = dict(MISTRAL_7B, dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16, use_flash_attention=True)
    fields.update(over)
    return GPTConfig(**fields)


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def mistral_decode_logits(engine, prompts, mask, k=MISTRAL_LOGIT_STEPS):
    """The logits of the prefill's last position and of ``k`` greedy decode
    steps, through a ``CompiledStep`` like the engine's decode runs: called
    uncaptured (the reference), then its warm-up, capturing and replaying
    calls, each after a fresh prefill into the same cache (the engine's
    cache kind: the ring of a window layout, else dense). Returns the
    eager logits, the generated tokens and whether each captured call's
    logits equal the eager ones bit for bit."""
    import torch

    from deepspeed_tpu_torch.runtime.compiled_step import CompiledStep

    model = engine.module
    # the engine's own cache for this batch size (its prefill graphs write
    # it)
    cache = engine._decoder(prompts.shape[0]).cache

    def steps(k, tok):
        out = []
        for _ in range(k):
            logits, _ = model(tok[:, None], decode=True, cache=cache)
            out.append(logits[:, -1])
            tok = logits[:, -1].argmax(-1)
        return torch.stack(out, dim=1)

    runs = CompiledStep(steps, engine.device, warmup=1)
    results = []
    with torch.inference_mode():
        for call in ("eager", "warmup", "capture", "replay"):
            # one pass, or the ring cache's block-aligned spans
            first, _ = engine._chunked_prefill(prompts, mask)
            lengths = cache.lengths.copy()
            run = runs.eager if call == "eager" else runs
            results.append(run({"tok": first.argmax(-1)}, k))
            cache.lengths[:] = lengths + k
    same = [bool(torch.equal(r, results[0])) for r in results[1:]]
    logits = torch.cat([first[:, None], results[0]], dim=1)   # [B, k + 1, V]
    del cache, runs
    return logits, logits[:, :-1].argmax(-1), same


def serve_lm(phase, make_config, *, model, source, config, reduced, batch,
             seq, prompt_lengths, logits_rel_l2, flash_layers=True,
             extra=None, part="serve"):
    """One model at full width through ``init_inference``, bf16, random
    weights from seed 0: ``forward`` on [batch, seq] (through B1 on every
    layer when ``flash_layers``, else with no B1 launch: ALiBi takes the
    einsum path) against the einsum path on the same weights (relative L2
    of the logits, ``logits_rel_l2``), ``generate`` for left-padded prompts
    of ``prompt_lengths`` with the decode graphs against eager decode
    (tokens, and the logits of a captured decode run bit for bit), cached
    decode against the full forward of the same sequences; forward, prefill
    and decode times, peak memory, and the card's time by kernel in one
    traced forward and one traced 8-token generate. ``extra(engine, ids)``
    adds to the line. Returns the launch counts of the forward and
    generate."""
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer_lm import GPT, num_params
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    cfg = make_config()
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = init_inference(GPT(cfg), dtype="bf16", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    width = max(prompt_lengths)
    prompts = torch.randint(0, cfg.vocab_size, (len(prompt_lengths), width),
                            generator=gen)
    # left-padded, as generate aligns them (the decode-logits check feeds
    # the model directly)
    mask = torch.arange(width)[None, :] >= \
        width - torch.tensor(prompt_lengths)[:, None]
    prompts = prompts * mask

    reset_launches()
    logits = engine(ids)
    torch.cuda.synchronize()
    forward_launches = fa.launches
    toks = engine.generate(prompts, max_new_tokens=MISTRAL_NEW_TOKENS,
                           attention_mask=mask)
    torch.cuda.synchronize()
    launches = read_launches()
    problems = []
    want_b1 = cfg.n_layer if flash_layers else 0
    if forward_launches != want_b1:
        problems.append(f"forward launched B1 {forward_launches} times, "
                        f"want {want_b1}")
    if tuple(logits.shape) != (batch, seq, cfg.vocab_size) or \
            logits.dtype != torch.float32 or \
            not bool(torch.isfinite(logits).all()):
        problems.append(f"logits {tuple(logits.shape)} {logits.dtype}, "
                        "finite: " + str(bool(torch.isfinite(logits).all())))
    if tuple(toks.shape) != (len(prompt_lengths), MISTRAL_NEW_TOKENS):
        problems.append(f"generate returned {tuple(toks.shape)}")
    line_extra = extra(engine, ids) if extra is not None else {}

    einsum = init_inference(GPT(make_config(use_flash_attention=False)),
                            dtype="bf16",
                            state_dict=engine.module.state_dict())
    logits_e = einsum(ids)
    flash_rel = _rel_l2(logits, logits_e)
    top1 = float((logits.argmax(-1) == logits_e.argmax(-1)).float().mean())
    del logits, logits_e, einsum
    free_cuda()

    forward_ms = wall_ms(lambda: engine(ids), reps=3)
    decode = compare_decode(engine, prompts, mask, n=MISTRAL_NEW_TOKENS)
    # cached decode against the full forward over the same sequences: the
    # left-aligned prompts (left pads, masked as keys) and the generated
    # tokens; rotary phases and ALiBi positions are the cache slots on both
    # sides
    dec_logits, dec_toks, graph_same = mistral_decode_logits(
        engine, prompts.cuda(), mask.cuda())
    seq_ids = torch.cat([prompts.cuda(), dec_toks], dim=1)
    seq_mask = torch.cat([mask.cuda(), torch.ones_like(dec_toks,
                                                       dtype=torch.bool)], 1)
    with torch.inference_mode():
        full = engine.module(seq_ids, attention_mask=seq_mask)
    full = full[:, width - 1:]                          # [B, k + 1, V]
    rollout_rel = _rel_l2(dec_logits, full)
    rollout_top1 = float((dec_logits.argmax(-1) == full.argmax(-1))
                         .float().mean())
    del full, dec_logits, seq_ids
    n = MISTRAL_NEW_TOKENS
    gen1_ms = wall_ms(lambda: engine.generate(prompts, max_new_tokens=1,
                                              attention_mask=mask), reps=3)
    gen_ms = wall_ms(lambda: engine.generate(prompts, max_new_tokens=n,
                                             attention_mask=mask), reps=3)
    eager_ms = wall_ms(lambda: eager_generate(engine, prompts, n, mask),
                       reps=1)
    # where the card's time goes: one traced forward, one traced 8-token
    # generate (prefill, then decode runs of 4, 2 and 1 steps, replayed)
    profile = {f"forward_{batch}x{seq}": _trace(lambda: engine(ids))[0],
               f"generate_{len(prompt_lengths)}_prompts_8_tokens": _trace(
                   lambda: engine.generate(prompts, max_new_tokens=8,
                                           attention_mask=mask))[0]}
    line = {"phase": phase, "part": part, "model": model,
            "source": source,
            "params": sum(p.numel() for p in engine.module.parameters()),
            # the reference's count (one dense MLP for a mixture of experts)
            "num_params_reference": num_params(cfg),
            "config": dict(config), "reduced": reduced,
            "dtype": "bf16", "init_s": init_s, "weights_gb": weights_gb,
            "forward_shape": [batch, seq],
            "forward_launches": forward_launches, "launches": launches,
            "flash_vs_einsum_logits_rel_l2": flash_rel,
            "flash_vs_einsum_top1_agreement": top1,
            "logits_rel_l2_tol": logits_rel_l2,
            "forward_ms": forward_ms,
            "forward_tokens_per_s": batch * seq / forward_ms * 1e3,
            "prompt_lengths": list(prompt_lengths), "new_tokens": n,
            "prefill_ms": gen1_ms,
            "decode_ms_per_token": (gen_ms - gen1_ms) / (n - 1),
            "eager_decode_ms_per_token": (eager_ms - gen1_ms) / (n - 1),
            "decode_graphs_vs_eager_tokens": decode,
            "decode_graphs_vs_eager_logits_identical": graph_same,
            "decode_vs_forward_logits_rel_l2": rollout_rel,
            "decode_vs_forward_top1_agreement": rollout_top1,
            "logit_steps": MISTRAL_LOGIT_STEPS, "profile": profile,
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            **line_extra}
    emit(line)
    if not flash_rel <= logits_rel_l2:
        problems.append(f"flash against einsum: relative L2 {flash_rel}")
    if not decode["identical"] or not all(graph_same):
        problems.append("decode graphs against eager decode differ")
    if not rollout_rel <= logits_rel_l2:
        problems.append(f"cached decode against the forward: relative L2 "
                        f"{rollout_rel}")
    if problems:
        raise AssertionError(f"{phase} {part}: {problems}")
    del engine
    free_cuda()
    return launches


def mistral_serve():
    """Mistral-7B, ``MISTRAL_SERVE_LAYERS`` layers, bf16, through
    ``init_inference``: the
    flash forward against the einsum path, the decode graphs against eager
    decode (tokens over ``generate``, logits over a captured decode run),
    cached decode against the full forward, and the serving times."""
    return serve_lm(
        "mistral", functools.partial(mistral_config,
                                     n_layer=MISTRAL_SERVE_LAYERS),
        model=f"mistral-7b-v0.1, {MISTRAL_SERVE_LAYERS} layers",
        source=MISTRAL_SOURCE, config=MISTRAL_7B,
        reduced={"n_positions": "32768 -> 4096 (the sliding window; the "
                 "policy attends over the whole context)",
                 "n_layer": f"32 -> {MISTRAL_SERVE_LAYERS} (the serving "
                 "phase serves 32)"},
        batch=2, seq=MISTRAL_SEQ, prompt_lengths=MISTRAL_PROMPT_LENGTHS,
        logits_rel_l2=MISTRAL_LOGITS_REL_L2)


def mistral_engine(seed=0, flash=True):
    """Mistral-7B's widths at ``MISTRAL_TRAIN_LAYERS`` layers through
    ``initialize`` with ``GPT_PRETRAIN_CONFIG`` (FusedAdam on B4, ZeRO 1,
    clip 1.0, bf16) at micro ``MISTRAL_MICRO``, full remat."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT

    model = GPT(mistral_config(n_layer=MISTRAL_TRAIN_LAYERS, remat=True,
                               use_flash_attention=flash))
    config = dict(GPT_PRETRAIN_CONFIG,
                  train_micro_batch_size_per_gpu=MISTRAL_MICRO)
    return deepspeed_tpu_torch.initialize(model=model, config=config,
                                          seed=seed)[0]


def mistral_train():
    """The 8-layer cut through initialize -> train_batch (``lm_train``):
    one einsum step, then 12 captured steps against 12 uncaptured ones
    from the same seed. Returns the launch counts of the captured run."""
    return lm_train(
        "mistral", mistral_engine,
        model=f"mistral-7b-v0.1, {MISTRAL_TRAIN_LAYERS} layers",
        reduced={"n_layer": f"32 -> {MISTRAL_TRAIN_LAYERS}",
                 "n_positions": "32768 -> 4096"},
        micro=MISTRAL_MICRO, seq=MISTRAL_SEQ, per_step=MISTRAL_PER_STEP,
        flops=lambda cfg: {"model_6n_plus_attention":
                           gpt_flops_per_token(cfg, MISTRAL_SEQ)})[0]


def mistral_kernels():
    """B1, B2 and B3 at the Mistral training shape [2, 4096, 32, 128]
    (``gqa_kernels``)."""
    return gqa_kernels("mistral", MISTRAL_MICRO, MISTRAL_SEQ,
                       MISTRAL_7B["n_head"], MISTRAL_7B["n_kv_head"],
                       MISTRAL_7B["n_embd"] // MISTRAL_7B["n_head"])


def gqa_kernels(phase, b, t, h, h_kv, d):
    """B1, B2 and B3 at a grouped-query training shape [b, t, h, d], bf16,
    causal: q as the rotary hands it over, k and v repeated from ``h_kv``
    KV heads. Each against its plain version on a slice (batch 1, heads
    0-7), then timed (device time) against its bound, its plain version at
    the full shape and SDPA's backends on the same tensors."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    group = h // h_kv
    gen = torch.Generator().manual_seed(50)
    q = torch.randn((b, t, h, d), generator=gen).to("cuda", torch.bfloat16)
    k, v = (torch.randn((b, t, h // group, d), generator=gen)
            .to("cuda", torch.bfloat16).repeat_interleave(group, dim=2)
            for _ in range(2))
    do = torch.randn((b, t, h, d), generator=gen).to("cuda", torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    sb, sh = MISTRAL_PLAIN_SLICE
    cut = [x[:sb, :, :sh].contiguous() for x in (q, k, v, do)]
    o_ref, lse_ref = fa.flash_attention_reference(*cut[:3], causal=True)
    want = fa.flash_attention_backward_reference(
        *cut[:3], o[:sb, :, :sh].contiguous(), lse[:sb, :sh].contiguous(),
        cut[3], causal=True)
    torch.cuda.synchronize()
    errs = {"o_max_abs": float((o[:sb, :, :sh].float()
                                - o_ref.float()).abs().max()),
            "lse_max_abs": float((lse[:sb, :sh] - lse_ref).abs().max())}
    errs.update({f"{n}_rel": _rel_err(g[:sb, :, :sh], w)
                 for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)})
    tol = {"o_max_abs": TOLERANCE["bfloat16"]["o"],
           "lse_max_abs": TOLERANCE["bfloat16"]["lse"],
           "grad_rel": GRAD_REL_TOL["bfloat16"]}
    ok = (errs["o_max_abs"] <= tol["o_max_abs"]
          and errs["lse_max_abs"] <= tol["lse_max_abs"]
          and max(errs[f"{n}_rel"] for n in ("dq", "dk", "dv"))
          <= tol["grad_rel"])
    del o_ref, lse_ref, want, cut, dq, dk, dv

    scale = d ** -0.5
    delta = fa.bwd_delta(o, do)
    args = (q, k, v, lse, delta, do, None, True, scale)
    times = {"flash_attention_fwd": device_ms(
                 lambda: fa._launch(q, k, v, None, True, scale)),
             "flash_attention_bwd_dq": device_ms(lambda: fa._launch_dq(*args)),
             "flash_attention_bwd_dkv": device_ms(
                 lambda: fa._launch_dkv(*args))}
    plain = {"fwd": device_ms(lambda: fa.flash_attention_reference(
                 q, k, v, causal=True), iters=3)["ms"],
             "bwd": device_ms(lambda: fa.flash_attention_backward_reference(
                 q, k, v, o, lse, do, causal=True), iters=3)["ms"]}
    free_cuda()
    sdpa, sdpa_fwd, sdpa_bwd = sdpa_yardstick(q, k, v, do, True)
    pairs = b * t * (t + 1) // 2
    bthd, bht = b * t * h * d * 2, b * h * t * 4
    work = {"flash_attention_fwd": attention_flops_bytes(b, t, h, d, True, 2),
            "flash_attention_bwd_dq": (6 * pairs * h * d, 5 * bthd + 2 * bht),
            "flash_attention_bwd_dkv": (8 * pairs * h * d,
                                        6 * bthd + 2 * bht)}
    out = {}
    for name, (n_ops, nbytes) in work.items():
        bound_ms, bound_by = _bound(n_ops, nbytes, "bfloat16")
        ms = times[name]["ms"]
        fwd = name == "flash_attention_fwd"
        cudnn = sdpa.get("cudnn", {}).get("fwd" if fwd else "bwd")
        out[name] = {"shape": [b, t, h, d], "ms": ms,
                     "device_time": times[name], "bound_ms": bound_ms,
                     "bound_by": bound_by, "flops": n_ops, "bytes": nbytes,
                     "tflops_per_s": n_ops / ms / 1e9,
                     "plain_ms": plain["fwd" if fwd else "bwd"],
                     "library_ms": (sdpa_fwd if fwd else sdpa_bwd)[1],
                     "library": (sdpa_fwd if fwd else sdpa_bwd)[0],
                     "cudnn_ms": None if cudnn is None else cudnn["ms"]}
    emit({"phase": phase, "part": "kernels", "shape": [b, t, h, d],
          "kv_heads_repeated_from": h_kv,
          "plain_slice": {"batch": sb, "heads": sh}, "errors": errs,
          "tolerance": tol, "timing": out, "sdpa_by_backend": sdpa,
          "note": "plain_ms and library_ms of B2/B3 compute dq, dk and dv "
                  "together"})
    del q, k, v, do, o, lse, delta, args
    free_cuda()
    if not ok:
        raise AssertionError(f"{phase} kernels: {errs} over {tol}")
    return out


def phase_mistral():
    """Mistral-7B-v0.1's LLaMA-shaped trunk (RMSNorm, SwiGLU, rotary, GQA,
    bias-free, untied head): serving and training at 8 layers,
    one packed batch, and B1-B3 at its attention shape. Returns the
    launch counts of the serve and train runs and the kernels' times at
    the Mistral shape."""
    import torch

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    serve = mistral_serve()
    train = mistral_train()
    free_cuda()
    packed = packed_exactness(
        mistral_config(n_layer=MISTRAL_TRAIN_LAYERS, remat=True),
        batch_size=MISTRAL_MICRO, seq_length=MISTRAL_SEQ)
    packed.pop("segment_ids")
    emit({"phase": "mistral", "part": "packed", "packed_exactness": packed})
    problems = []
    if packed["loss_rel_err"] > PACKED_LOSS_REL_TOL:
        problems.append("packed flash and einsum losses disagree")
    if packed["grad_norm_rel_err"] > PACKED_GNORM_REL_TOL:
        problems.append("packed flash and einsum grad norms disagree")
    if not packed["isolation"]["other_bit_identical"]:
        problems.append("a document's change reached another document")
    seg = packed["flash_launches"]
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        if seg[name] == 0 or seg[name + "_segment"] != seg[name]:
            problems.append(f"{name}: not all in the segment variant: {seg}")
    if problems:
        raise AssertionError(f"mistral packed: {problems}")
    kernels = mistral_kernels()
    emit({"phase": "mistral", "part": "done", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0,
          "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"mistral_serve": serve, "mistral_train": train}, kernels



# Pythia-6.9B (https://huggingface.co/EleutherAI/pythia-6.9b/blob/main/
# config.json) as deepspeed_tpu/module_inject/hf.py:266 (gptneox_from_hf)
# configures it: the parallel residual, rotary on 25% of each head, exact
# GELU, biases, an untied head
PYTHIA_6P9B = dict(vocab_size=50432, n_positions=2048, n_embd=4096,
                   n_layer=32, n_head=32, intermediate_size=16384,
                   layer_norm_epsilon=1e-5, activation="gelu", rotary=True,
                   rotary_pct=0.25, rope_theta=10000.0,
                   learned_positions=False, tie_word_embeddings=False,
                   parallel_residual=True)
PYTHIA_SOURCE = ("https://huggingface.co/EleutherAI/pythia-6.9b/blob/main/"
                 "config.json")
# BLOOM-7b1 (https://huggingface.co/bigscience/bloom-7b1/blob/main/
# config.json) as hf.py:813 (bloom_from_hf) configures it: ALiBi, the
# embedding LayerNorm, the tanh GELU, biases, a tied head, 2048 positions
BLOOM_7B1 = dict(vocab_size=250880, n_positions=2048, n_embd=4096,
                 n_layer=30, n_head=32, layer_norm_epsilon=1e-5,
                 activation="gelu_tanh", alibi=True, embed_layernorm=True,
                 learned_positions=False, tie_word_embeddings=True)
BLOOM_SOURCE = ("https://huggingface.co/bigscience/bloom-7b1/blob/main/"
                "config.json")
NEOX_SEQ = 2048
# training cuts Pythia's depth: ZeRO-1 bf16 holds ~12 bytes per parameter,
# 2.02 B parameters at 8 layers (~24 GB); every layer is alike
PYTHIA_TRAIN_LAYERS = 8
PYTHIA_MICRO = 4
PYTHIA_PER_STEP = {"flash_attention_fwd": 2 * PYTHIA_TRAIN_LAYERS,
                   "flash_attention_bwd_dq": PYTHIA_TRAIN_LAYERS,
                   "flash_attention_bwd_dkv": PYTHIA_TRAIN_LAYERS,
                   "fused_adamw": 1}
# serving prompts within BLOOM's and Pythia's 2048 positions
NEOX_PROMPT_LENGTHS = (37, 128, 300, 512)
# serving's depth cuts (PERF.md section 4): each check is per layer or on
# the stack's output, and the serving phase runs the engine's paths at a
# whole model's depth
PYTHIA_SERVE_LAYERS = 16
BLOOM_SERVE_LAYERS = 15


def neox_config(fields, **over):
    import torch

    from deepspeed_tpu_torch.models.transformer_lm import GPTConfig

    cfg = dict(fields, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
               use_flash_attention=True)
    cfg.update(over)
    return GPTConfig(**cfg)


def lm_train(phase, make_engine, *, model, reduced, micro, seq, per_step,
             flops, noise_check=False):
    """A depth cut through initialize -> train_batch (``make_engine(flash=
    ...)``): one einsum step against the flash step, then 12 captured steps
    against 12 uncaptured ones from the same seed (bit for bit), the loss
    falling, ``per_step`` launches per step and no segment variant.
    ``flops(cfg)`` gives ``{name: FLOPs per token}`` for the line (the
    first is the model TFLOP/s). With ``noise_check`` two more replays
    after the 12 must draw different gating noise. Returns the launch
    counts of the captured run."""
    import numpy as np
    import torch

    free_cuda()
    einsum = make_engine(flash=False)
    cfg = einsum.module.config
    params = sum(p.numel() for p in einsum.module.parameters())
    rng = np.random.RandomState(1)
    ids = rng.randint(0, cfg.vocab_size, size=(micro, seq)).astype(np.int64)
    batch = {"input_ids": ids, "labels": ids}
    loss_e = float(einsum.train_batch(iter([batch])))
    gnorm_e = einsum.get_global_grad_norm()
    del einsum
    free_cuda()

    noise = {}

    def after_the_steps(engine, it):
        # with noise_check, two more replays of the step's graph: the
        # gating noise buffer after each (the generator is registered with
        # the graph); then one traced replay, the card's time by kernel
        if noise_check:
            bufs = []
            for _ in range(2):
                engine.train_batch(it)
                bufs.append(torch.cat([b.flatten() for b in
                                       engine._gating_noise.values()]).clone())
            torch.cuda.synchronize()
            noise["replays_draw_different_noise"] = not torch.equal(*bufs)
            noise["noise_elements"] = int(bufs[0].numel())
        noise["profile_replay"] = _trace(lambda: engine.train_batch(it))[0]

    torch.cuda.reset_peak_memory_stats()
    check, launches, losses, norms, times, e_losses, e_times = \
        captured_against_eager(make_engine, [batch], STEPS,
                               traced=after_the_steps)
    ms, eager_ms = step_medians(times, e_times)
    tokens = micro * seq
    fpt = flops(cfg)
    first = next(iter(fpt.values()))
    tflops = tokens * first / ms / 1e9
    line = {"phase": phase, "part": "train", "model": model,
            "params_numel": params, "reduced": reduced,
            "config": dict(GPT_PRETRAIN_CONFIG,
                           train_micro_batch_size_per_gpu=micro),
            "batch": [micro, seq], "losses": losses,
            "eager_losses": e_losses,
            "flash_vs_einsum": {"loss": [losses[0], loss_e],
                                "grad_norm": [norms[0], gnorm_e]},
            "captured_vs_eager": check, "launches": launches,
            "steps": STEPS, "step_ms_median": ms, "step_ms": times,
            "eager_step_ms_median": eager_ms,
            "tokens_per_s": tokens / ms * 1e3,
            "flops_per_token": fpt,
            "tflops_per_s": {k: tokens * v / ms / 1e9 for k, v in fpt.items()},
            "model_tflops_per_s": tflops, "mfu_vs_989": tflops / 989.0,
            "peak_allocated_gb": check["peak_allocated_gb"], **noise}
    emit(line)
    problems = []
    if not all(np.isfinite(losses)):
        problems.append("non-finite loss")
    if not losses[-1] <= losses[0] - TRAIN_MIN_LOSS_DROP:
        problems.append(f"loss did not fall by {TRAIN_MIN_LOSS_DROP}")
    for name, per in {**per_step, **UNSEGMENTED}.items():
        if launches[name] != per * STEPS:
            problems.append(f"{name}: {launches[name]} launches, want "
                            f"{per} x {STEPS}")
    if abs(losses[0] - loss_e) > TRAIN_LOSS_REL_TOL * abs(loss_e):
        problems.append("flash and einsum losses disagree")
    if abs(norms[0] - gnorm_e) > TRAIN_GNORM_REL_TOL * abs(gnorm_e):
        problems.append("flash and einsum grad norms disagree")
    if not check["identical"]:
        problems.append("captured and eager steps differ")
    if noise_check and not noise.get("replays_draw_different_noise"):
        problems.append("two replays drew the same gating noise")
    if problems:
        raise AssertionError(f"{phase} train: {problems}")
    return launches, ms


def pythia_engine(seed=0, flash=True):
    """Pythia-6.9B's widths at ``PYTHIA_TRAIN_LAYERS`` layers through
    ``initialize`` with ``GPT_PRETRAIN_CONFIG`` at micro ``PYTHIA_MICRO``,
    full remat."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT

    model = GPT(neox_config(PYTHIA_6P9B, n_layer=PYTHIA_TRAIN_LAYERS,
                            remat=True, use_flash_attention=flash))
    config = dict(GPT_PRETRAIN_CONFIG,
                  train_micro_batch_size_per_gpu=PYTHIA_MICRO)
    return deepspeed_tpu_torch.initialize(model=model, config=config,
                                          seed=seed)[0]


def phase_neox():
    """The parallel residual, partial rotary, ALiBi and the embedding
    LayerNorm: Pythia-6.9B served at 16 layers and trained at 8,
    BLOOM-7b1 served at 15 (ALiBi keeps it off B1). Returns the launch
    counts by path."""
    import torch

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    pythia = serve_lm(
        "neox", functools.partial(neox_config, PYTHIA_6P9B,
                                  n_layer=PYTHIA_SERVE_LAYERS),
        model=f"pythia-6.9b, {PYTHIA_SERVE_LAYERS} layers",
        source=PYTHIA_SOURCE, config=PYTHIA_6P9B,
        reduced={"n_layer": f"32 -> {PYTHIA_SERVE_LAYERS}"}, batch=2,
        seq=NEOX_SEQ,
        prompt_lengths=NEOX_PROMPT_LENGTHS,
        logits_rel_l2=MISTRAL_LOGITS_REL_L2, part="pythia_serve")
    train, _ = lm_train(
        "neox", pythia_engine,
        model=f"pythia-6.9b, {PYTHIA_TRAIN_LAYERS} layers",
        reduced={"n_layer": f"32 -> {PYTHIA_TRAIN_LAYERS}"},
        micro=PYTHIA_MICRO, seq=NEOX_SEQ, per_step=PYTHIA_PER_STEP,
        flops=lambda cfg: {"model_6n_plus_attention":
                           gpt_flops_per_token(cfg, NEOX_SEQ)})
    bloom = serve_lm(
        "neox", functools.partial(neox_config, BLOOM_7B1,
                                  n_layer=BLOOM_SERVE_LAYERS),
        model=f"bloom-7b1, {BLOOM_SERVE_LAYERS} layers",
        source=BLOOM_SOURCE, config=BLOOM_7B1,
        reduced={"n_layer": f"30 -> {BLOOM_SERVE_LAYERS}"}, batch=1,
        seq=NEOX_SEQ,
        prompt_lengths=NEOX_PROMPT_LENGTHS,
        logits_rel_l2=MISTRAL_LOGITS_REL_L2, flash_layers=False,
        part="bloom_serve")
    emit({"phase": "neox", "part": "done", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0,
          "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"neox_serve": pythia, "neox_train": train, "bloom_serve": bloom}


# Mixtral-8x7B-v0.1 (https://huggingface.co/mistralai/Mixtral-8x7B-v0.1/
# blob/main/config.json) as hf.py:590 (mixtral_from_hf) configures it: the
# Mistral trunk (RMSNorm, 32 query over 8 KV heads, rotary at theta 1e6, no
# biases, an untied head) with 8 gated-SiLU experts, top-2, the router's
# aux coefficient 0.02, capacity factors 2.0 (training) and 4.0 (eval);
# n_positions cut to 4096 as for Mistral
MIXTRAL_8X7B = dict(vocab_size=32000, n_positions=4096, n_embd=4096,
                    n_layer=32, n_head=32, n_kv_head=8,
                    intermediate_size=14336, layer_norm_epsilon=1e-5,
                    norm="rmsnorm", activation="silu", use_bias=False,
                    rotary=True, rope_theta=1e6, learned_positions=False,
                    tie_word_embeddings=False, moe_num_experts=8,
                    moe_top_k=2, moe_gated_experts=True,
                    moe_aux_loss_coef=0.02, moe_capacity_factor=2.0,
                    moe_eval_capacity_factor=4.0)
MIXTRAL_SOURCE = ("https://huggingface.co/mistralai/Mixtral-8x7B-v0.1/blob/"
                  "main/config.json")
# 1,451,270,144 parameters a layer (2.9 GB in bf16): 16 layers serve in
# ~47 GB of one card, all 32 would take 93 GB; the depth is cut to 8
# (PERF.md section 4): each check is per layer or on the stack's output
MIXTRAL_SERVE_LAYERS = 8
# 3,164,688,384 parameters at 2 layers, ~38 GB of ZeRO-1 state at 12 bytes
# a parameter; every layer is alike
MIXTRAL_TRAIN_LAYERS = 2
MIXTRAL_MICRO = 2
# B4 launches once per parameter dtype: the bf16 weights and the gates,
# which stay f32 under a bf16 param_dtype (as in JAX)
MIXTRAL_PER_STEP = {"flash_attention_fwd": 2 * MIXTRAL_TRAIN_LAYERS,
                    "flash_attention_bwd_dq": MIXTRAL_TRAIN_LAYERS,
                    "flash_attention_bwd_dkv": MIXTRAL_TRAIN_LAYERS,
                    "fused_adamw": 2}
# the index dispatch/combine against the dense one-hot products: dispatch
# copies exactly; the f32 combine sums the same two products per element,
# cuBLAS's with a fused multiply-add, so they part by an f32 rounding
MOE_COMBINE_REL_L2 = 1e-6
MOE_SMALL = dict(vocab_size=512, n_positions=128, n_embd=256, n_layer=2,
                 n_head=4, n_kv_head=2, intermediate_size=384,
                 norm="rmsnorm", activation="silu", use_bias=False,
                 rotary=True, learned_positions=False,
                 tie_word_embeddings=False, moe_num_experts=4,
                 moe_top_k=1, moe_noisy_gate_policy="RSample",
                 moe_capacity_factor=1.0, use_flash_attention=True,
                 remat=True)
MOE_SMALL_STEPS = 6


def mixtral_config(**over):
    return neox_config(MIXTRAL_8X7B, **over)


def moe_flops_per_token(cfg, seq, tokens):
    """Training FLOPs per token of a mixture-of-experts GPT, from its
    parameters (``num_params`` counts one dense MLP, as in JAX). ``active``:
    6 x (the non-embedding parameters a token uses: k of E experts) plus
    the attention term of ``gpt_flops_per_token``. ``executed``: what the
    step runs, the experts at their capacity-padded E x C rows for
    ``tokens`` tokens, and the forward twice under full remat (8 in place
    of 6)."""
    from deepspeed_tpu_torch.models.transformer_lm import GPT
    from deepspeed_tpu_torch.moe.sharded_moe import static_capacity

    model = GPT(cfg)
    expert = sum(p.numel() for n, p in model.named_parameters()
                 if ".experts." in n)
    other = sum(p.numel() for n, p in model.named_parameters()
                if ".experts." not in n and n != "wte.weight")
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    cf = cfg.moe_capacity_factor * (2.0 if k == 2 else 1.0)
    C = static_capacity(tokens, E, cf, cfg.moe_min_capacity)
    attn = 6 * cfg.n_layer * cfg.n_embd * seq
    return {"active": 6.0 * (other + expert * k / E) + attn,
            "executed": 8.0 * (other + expert * C / tokens) + attn * 8 / 6}


def mixtral_exp_counts(engine, ids):
    """Each layer's tokens routed to each expert (first choice) in one
    forward: routing that is not degenerate sends tokens to every
    expert."""
    import torch

    counts = []
    hooks = [blk.mlp.register_forward_hook(
        lambda mod, args, out: counts.append(out[2].tolist()))
        for blk in engine.module.h]
    try:
        with torch.inference_mode():
            engine.module(ids.to(engine.device))
    finally:
        for h in hooks:
            h.remove()
    used = [sum(1 for c in layer if c > 0) for layer in counts]
    if used[0] != len(counts[0]):
        raise AssertionError(f"the first layer routed to {used[0]} of "
                             f"{len(counts[0])} experts: {counts[0]}")
    return {"exp_counts_by_layer": counts, "experts_used_by_layer": used}


def mixtral_engine(seed=0, flash=True):
    """Mixtral-8x7B's widths at ``MIXTRAL_TRAIN_LAYERS`` layers through
    ``initialize`` with ``GPT_PRETRAIN_CONFIG`` at micro ``MIXTRAL_MICRO``,
    full remat; the engine draws the gating noise."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT

    model = GPT(mixtral_config(n_layer=MIXTRAL_TRAIN_LAYERS, remat=True,
                               use_flash_attention=flash))
    config = dict(GPT_PRETRAIN_CONFIG,
                  train_micro_batch_size_per_gpu=MIXTRAL_MICRO)
    return deepspeed_tpu_torch.initialize(model=model, config=config,
                                          seed=seed)[0]


def moe_dispatch_combine():
    """The index dispatch/combine against the dense one-hot products at
    Mixtral's training shape (T 8192 tokens, E 8, top-2 at factor 2.0: C
    4096, M 4096): the same gating output, bf16 tokens and expert outputs;
    dispatch bit for bit, the f32 combine within ``MOE_COMBINE_REL_L2``;
    each timed (device time), forward and the combine's backward."""
    import torch

    from deepspeed_tpu_torch.moe import sharded_moe as sm

    T, E, M = MIXTRAL_MICRO * MISTRAL_SEQ, 8, MIXTRAL_8X7B["n_embd"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    logits = torch.randn((T, E), generator=gen, device="cuda")
    gumbel = torch.empty((T, E), device="cuda")
    from deepspeed_tpu_torch.moe.layer import draw_gating_noise

    draw_gating_noise(gumbel[None], ("gumbel",), gen)
    gout = sm.top2_gating(logits, MIXTRAL_8X7B["moe_capacity_factor"], 4,
                          gumbel=gumbel)
    r = gout.routing
    C = r.capacity
    x = torch.randn((T, M), generator=gen, device="cuda").bfloat16()
    eo = torch.randn((E, C, M), generator=gen, device="cuda").bfloat16()
    dy = torch.randn((T, M), generator=gen, device="cuda").bfloat16()
    mask, weights = gout.dispatch_mask, gout.combine_weights
    d_dense = sm.dispatch_tokens(mask, x)
    d_index = sm.dispatch_by_index(r, x)
    c_dense = sm.combine_tokens(weights, eo, dtype=torch.bfloat16)
    c_index = sm.combine_by_index(r, eo, dtype=torch.bfloat16)
    c_dense32 = sm.combine_tokens(weights, eo)
    c_index32 = sm.combine_by_index(r, eo)
    torch.cuda.synchronize()
    out = {"shape": {"tokens": T, "experts": E, "capacity": C, "width": M},
           "kept_choices": int(r.kept.sum()),
           "dispatch_identical": bool(torch.equal(d_dense, d_index)),
           "combine_f32_rel_l2": _rel_l2(c_index32, c_dense32),
           "combine_bf16_max_abs": float((c_index.float()
                                          - c_dense.float()).abs().max())}

    # the combine's backward, as training runs it: the gradients of the
    # expert outputs and of the weights (which reach the gate)
    eo_ = eo.detach().requires_grad_(True)
    dense_w = weights.detach().requires_grad_(True)
    r_w = dataclasses.replace(r, weights=r.weights.detach()
                              .requires_grad_(True))

    def dense_bwd():
        y = sm.combine_tokens(dense_w, eo_, dtype=torch.bfloat16)
        return torch.autograd.grad(y, (dense_w, eo_), dy)

    def index_bwd():
        y = sm.combine_by_index(r_w, eo_, dtype=torch.bfloat16)
        return torch.autograd.grad(y, (r_w.weights, eo_), dy)

    times = {
        "dispatch_dense": device_ms(lambda: sm.dispatch_tokens(mask, x),
                                    iters=5),
        "dispatch_index": device_ms(lambda: sm.dispatch_by_index(r, x)),
        "combine_dense_f32": device_ms(lambda: sm.combine_tokens(
            dense_w, eo, dtype=torch.bfloat16), iters=5),
        "combine_index": device_ms(lambda: sm.combine_by_index(
            r, eo, dtype=torch.bfloat16)),
        "combine_dense_f32_with_backward": device_ms(dense_bwd, iters=5),
        "combine_index_with_backward": device_ms(index_bwd),
        "gating_top2": device_ms(lambda: sm.top2_gating(
            logits, MIXTRAL_8X7B["moe_capacity_factor"], 4, gumbel=gumbel)),
    }
    out["ms"] = {k: v["ms"] for k, v in times.items()}
    out["device_time"] = times
    # the dense products' work: 2 T E C M each, the combine in true f32
    # (TF32 is off), its backward two more such products
    flops = 2 * T * E * C * M
    out["dense_flops_each"] = flops
    out["combine_dense_f32_tflops_per_s"] = flops / times[
        "combine_dense_f32"]["ms"] / 1e9
    del d_dense, d_index, c_dense, c_index, mask, weights, dense_w, eo, x
    del eo_, r_w
    free_cuda()
    return out


def moe_small_engine(seed=5, stage=None, **over):
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT, GPTConfig

    cfg = GPTConfig(**dict(MOE_SMALL, dtype=torch.float32, **over))
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": "FusedAdam",
                            "params": {"lr": SMALL_LR, "weight_decay": 0.1}},
              "steps_per_print": 10 ** 9, "tpu": {"use_pallas_optimizer": True}}
    if stage is not None:
        config["zero_optimization"] = {"stage": stage}
    return deepspeed_tpu_torch.initialize(model=GPT(cfg), config=config,
                                          seed=seed)[0]


def moe_small():
    """A small top-1 MoE GPT (RSample noise and random token selection, the
    engine's gating generator) on the card: a tag saved after 3 steps holds
    one file per expert and kind, the JAX schema's manifest lists them, and
    a fresh engine from another seed that loads it takes the next 3 steps
    bit for bit (losses, noise, parameters); then ZeRO stages 0-2 on a
    one-rank NCCL group, captured against uncaptured, against the
    group-less engine."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime import checkpoint_manifest as cm
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    rng = np.random.RandomState(4)
    batches = [{"input_ids": x, "labels": x}
               for x in rng.randint(0, 512, size=(2, 2, 128))]
    ckpt_dir = os.path.join(CKPT_DIR, "moe")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = {}
    try:
        a = moe_small_engine()
        it = iter(RepeatingLoader(batches))
        train_steps(a, it, 3)
        a.save_checkpoint(ckpt_dir)
        tag_dir = os.path.join(ckpt_dir, "global_step3")
        files = sorted(os.listdir(tag_dir))
        manifest = cm.read_manifest(tag_dir)
        want = [f"expert_{e}_mp_rank_00_{k}_states.pt"
                for e in range(MOE_SMALL["moe_num_experts"])
                for k in ("model", "optim")]
        a_losses, _, _ = train_steps(a, it, 3)
        a_noise = torch.cat([b.flatten() for b in
                             a._gating_noise.values()]).clone()
        a_params = {k: v.clone() for k, v in a.params.items()}
        del a
        free_cuda()
        b = moe_small_engine(seed=11)
        b.load_checkpoint(ckpt_dir)
        it_b = iter(RepeatingLoader(batches))
        next(it_b)  # the loader's place after 3 steps of two batches
        b_losses, _, _ = train_steps(b, it_b, 3)
        b_noise = torch.cat([x.flatten() for x in
                             b._gating_noise.values()])
        out["checkpoint"] = {
            "expert_files": [f for f in files if f.startswith("expert_")],
            "expert_files_complete": all(f in files for f in want),
            "manifest_lists_them": all(f in manifest["files"] for f in want),
            "verify_tag_dir": cm.verify_tag_dir(tag_dir),
            "resume_losses_identical": identical(a_losses, b_losses),
            "resume_noise_identical": bool(torch.equal(a_noise, b_noise)),
            "resume_params_identical": first_difference(
                a_params, b.params) is None}
        del b, a_params
        free_cuda()
        ref, _, _ = train_steps(moe_small_engine(),
                                iter(RepeatingLoader(batches)),
                                MOE_SMALL_STEPS)
        ref = [float(x) for x in ref]
        comm.init_distributed()
        stages = {}
        for stage in (0, 1, 2):
            check, _, losses, _, _, e_losses, _ = captured_against_eager(
                functools.partial(moe_small_engine, stage=stage), batches,
                MOE_SMALL_STEPS)
            rel = max(abs(x - y) / abs(y) for x, y in zip(losses, ref))
            stages[stage] = {"identical": check["identical"],
                             "loss_rel_err_vs_no_group": rel,
                             "losses": losses}
        out["zero_world_1"] = stages
    finally:
        if comm.is_initialized():
            comm.destroy_distributed()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit({"phase": "moe", "part": "small", **out})
    ck = out["checkpoint"]
    problems = [k for k in ("expert_files_complete", "manifest_lists_them",
                            "resume_losses_identical",
                            "resume_noise_identical",
                            "resume_params_identical") if not ck[k]]
    if ck["verify_tag_dir"]:
        problems.append(f"verify_tag_dir: {ck['verify_tag_dir']}")
    for stage, run in out["zero_world_1"].items():
        if not run["identical"]:
            problems.append(f"stage {stage}: captured and eager differ")
        if run["loss_rel_err_vs_no_group"] > ZERO_SMALL_LOSS_REL_TOL:
            problems.append(f"stage {stage}: losses against the group-less "
                            f"engine {run['loss_rel_err_vs_no_group']}")
    if problems:
        raise AssertionError(f"moe small: {problems}")


def phase_moe():
    """Mixtral-8x7B: serving at 8 layers, training at 2 with the engine's
    gating noise, the index dispatch/combine against the dense products,
    and the small model's checkpoint and ZeRO paths. Returns the launch
    counts by path."""
    import torch

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    serve = serve_lm(
        "moe", functools.partial(mixtral_config,
                                 n_layer=MIXTRAL_SERVE_LAYERS),
        model=f"mixtral-8x7b-v0.1, {MIXTRAL_SERVE_LAYERS} layers",
        source=MIXTRAL_SOURCE, config=MIXTRAL_8X7B,
        reduced={"n_layer": f"32 -> {MIXTRAL_SERVE_LAYERS} (all 32 need ep "
                 "over cards, ROADMAP A.9; 16 fit one card)",
                 "n_positions": "32768 -> 4096"},
        batch=1, seq=MISTRAL_SEQ, prompt_lengths=MISTRAL_PROMPT_LENGTHS,
        logits_rel_l2=MISTRAL_LOGITS_REL_L2, extra=mixtral_exp_counts)
    tokens = MIXTRAL_MICRO * MISTRAL_SEQ
    train, step_ms = lm_train(
        "moe", mixtral_engine,
        model=f"mixtral-8x7b-v0.1, {MIXTRAL_TRAIN_LAYERS} layers",
        reduced={"n_layer": f"32 -> {MIXTRAL_TRAIN_LAYERS}",
                 "n_positions": "32768 -> 4096"},
        micro=MIXTRAL_MICRO, seq=MISTRAL_SEQ, per_step=MIXTRAL_PER_STEP,
        flops=lambda cfg: moe_flops_per_token(cfg, MISTRAL_SEQ, tokens),
        noise_check=True)
    dc = moe_dispatch_combine()
    # what the dense products would add to the step: per layer the combine
    # in the forward and the recompute, and its backward; the dispatch
    # likewise (its backward is the same product again)
    ms, L = dc["ms"], MIXTRAL_TRAIN_LAYERS
    dense = L * (ms["combine_dense_f32"] + ms["combine_dense_f32_with_backward"]
                 + 3 * ms["dispatch_dense"])
    index = L * (ms["combine_index"] + ms["combine_index_with_backward"]
                 + 3 * ms["dispatch_index"])
    dc.update(step_ms=step_ms, dense_ms_per_step=dense,
              index_ms_per_step=index,
              dense_share_of_step=dense / (step_ms - index + dense),
              index_share_of_step=index / step_ms)
    emit({"phase": "moe", "part": "dispatch_combine", **dc})
    if not dc["dispatch_identical"] or \
            not dc["combine_f32_rel_l2"] <= MOE_COMBINE_REL_L2:
        raise AssertionError(f"moe dispatch/combine: {dc}")
    moe_small()
    emit({"phase": "moe", "part": "done", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0,
          "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"moe_serve": serve, "moe_train": train}


def phase_small_train():
    """A small f32 GPT trained 3 steps on the card (the kernels) and on the
    CPU (their plain versions) from the same weights and batches."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT, GPTConfig

    cfg = GPTConfig(vocab_size=512, n_positions=128, n_embd=256, n_layer=2,
                    n_head=4, dtype=torch.float32, use_flash_attention=True)
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": "FusedAdam",
                            "params": {"lr": SMALL_LR, "weight_decay": 0.1}},
              "steps_per_print": 10 ** 9, "tpu": {"use_pallas_optimizer": True}}
    rng = np.random.RandomState(4)
    batches = [{"input_ids": x, "labels": x}
               for x in rng.randint(0, 512, size=(3, 2, 128))]
    cpu, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT(cfg), config=config, seed=5, device="cpu")
    start = {k: v.clone() for k, v in cpu.module.state_dict().items()}
    card, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT(cfg), config=config,
        model_parameters={k: v.clone() for k, v in start.items()})
    reset_launches()
    card_losses = [float(card.train_batch(iter([b]))) for b in batches]
    launches = read_launches()
    cpu_losses = [float(cpu.train_batch(iter([b]))) for b in batches]
    got = {k: v.cpu() for k, v in card.module.state_dict().items()}
    want = cpu.module.state_dict()
    C = cfg.n_embd
    param_err, diff_sq, upd_sq = 0.0, 0.0, 0.0
    for name, w in want.items():
        g, w0 = got[name], start[name]
        if name.endswith("attn.c_attn.bias"):  # without the key part
            g, w, w0 = (torch.cat([x[:C], x[2 * C:]]) for x in (g, w, w0))
        param_err = max(param_err, float((g - w).abs().max()))
        diff_sq += float(((g - w) ** 2).sum())
        upd_sq += float(((w - w0) ** 2).sum())
    update_err = (diff_sq / upd_sq) ** 0.5
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    line = {"phase": "small_train", "card_losses": card_losses,
            "cpu_losses": cpu_losses, "loss_rel_err": loss_err,
            "update_rel_l2_err": update_err, "param_max_abs_err": param_err,
            "launches": launches}
    emit(line)
    # no remat here: one B1, B2 and B3 launch per layer and step
    want_launches = {"flash_attention_fwd": 3 * cfg.n_layer,
                     "flash_attention_bwd_dq": 3 * cfg.n_layer,
                     "flash_attention_bwd_dkv": 3 * cfg.n_layer,
                     "fused_adamw": 3, "block_sparse_fwd": 0,
                     "block_sparse_dq": 0, "block_sparse_dkv": 0,
                     **UNSEGMENTED}
    if not (loss_err <= SMALL_LOSS_REL_TOL and update_err <= SMALL_UPDATE_REL_L2
            and launches == want_launches):
        raise AssertionError(f"small_train: {line}")


# ---------------------------------------------------------------------------
# zero: data parallelism and ZeRO stages 0-3 over NCCL, one rank per card
# ---------------------------------------------------------------------------
ZERO_STAGES = (0, 1, 2, 3)
ZERO_DIR = os.path.join("build", "chip_smoke_zero")
# a rank process's limit, and the process group's rendezvous and collective
# timeout (rank 0 runs the group-less reference engine before it joins)
ZERO_RANK_TIMEOUT_S = 900
ZERO_GROUP_TIMEOUT_S = 600
# the 1.3B runs against a group-less engine on one card fed the same global
# batches at gas = world, over the 12 steps: the loss of each step to this
# relative error, the parameters' updates to this relative L2. At world 1
# only the global norm's summation order differs (one flat buffer against
# 292 tensors); the card gave identical losses and parameters (0.0 and
# 0.0). At world 4 each rank's bf16 gradients are summed in bf16 by NCCL
# against the reference's f32 accumulation of the micro steps: the card
# gave at most 1.72e-4 and 0.036 over stages 0-2 (PERF.md section 5). The
# bounds are about 3x those
ZERO_LOSS_REL_TOL = 6e-4
ZERO_UPDATE_REL_L2 = 0.12
# each step's global grad norm against the group-less engine's, relative.
# The first step's gradients come from the same parameters, so only the
# exchange's rounding parts them: at world 4 the card gave 7.7e-6 at most
# (stages 0-2, two runs, identical readings); later steps follow the
# parameters' drift, up to 2.5e-2. The bounds are about 3x those. The
# control (the group-less engine on all ranks' rows but the last's) lay
# 0.105 off at the first step and up to 1.46 later, with its losses 7.0e-2
# and its updates 0.74 off (PERF.md section 6)
ZERO_GRAD_NORM_FIRST_REL_TOL = 2.5e-5
ZERO_GRAD_NORM_REL_TOL = 8e-2
# the small f32 GPT's checkpoint resumed at another stage or on one card:
# the CPU tests' bounds (tests/test_torch_zero.py)
ZERO_SMALL_LOSS_REL_TOL = 1e-5
ZERO_SMALL_UPDATE_REL_L2 = 1e-3
# GPT-2 1.3B's parameter count (num_params of gpt2-1.3b at 1024 positions)
GPT_1P3B_PARAMS = 1_313_626_112
# the one-card captured step and B4's time over 1.3B (PERF.md sections 5
# and 6, on an H100 80GB HBM3 at 700 W): the terms of the predicted
# world-w step
ONE_CARD_STEP_MS = 126.9
B4_MS = 9.936
# bytes of the all-reduce yardstick: GPT-2 1.3B's bf16 gradient
ZERO_YARDSTICK_BYTES = 2 * GPT_1P3B_PARAMS
# GPT-2 6.7B (whose state, 12N = 80 GB, no one card holds) at stages 2 and
# 3: on at least this many cards, at this micro batch per rank
SIXB_MIN_WORLD = 4
SIXB_MICRO = 4
SIXB_PER_STEP = {"flash_attention_fwd": 64, "flash_attention_bwd_dq": 32,
                 "flash_attention_bwd_dkv": 32, "fused_adamw": 1}
NCCL_KINDS = {"AllReduce": "all_reduce", "ReduceScatter": "reduce_scatter",
              "AllGather": "all_gather", "Broadcast": "broadcast",
              "SendRecv": "all_to_all"}


def zero_config(stage, gas=1, **over):
    """``GPT_PRETRAIN_CONFIG`` at ZeRO ``stage`` with the comms logger on."""
    config = dict(GPT_PRETRAIN_CONFIG, zero_optimization={"stage": stage},
                  gradient_accumulation_steps=gas,
                  comms_logger={"enabled": True})
    config.update(over)
    return config


def zero_predicted_gb(stage, world, gas=1, model="gpt2-1.3b"):
    """The state bytes a rank holds (GPT-2 1.3B, or ``model``): bf16
    parameters and full bf16 gradients (2N each), f32 moments (8N, or 8N / w
    when partitioned) and, at gas > 1, f32 accumulators (4N, or 4N / w at
    stages 2-3). At stage 3 the partitioned leaves hold 12 bytes each over
    w (parameter, gradient and moments), and the P leaves under the
    persistence threshold stay whole (2P + 2P, moments 8P / w)."""
    from deepspeed_tpu_torch.models.transformer_lm import GPT, gpt2_config
    from deepspeed_tpu_torch.runtime.config import ZeroConfig

    shapes = [p.shape for p in GPT(gpt2_config(
        model, n_positions=1024)).parameters()]  # on the meta device
    n = sum(math.prod(s) for s in shapes)
    threshold = ZeroConfig().param_persistence_threshold
    whole = sum(math.prod(s) for s in shapes if math.prod(s) < threshold)
    acc = 0 if gas == 1 else 4 * n / (world if stage >= 2 else 1)
    if stage >= 3:
        return (12 * (n - whole) / world + 4 * whole + 8 * whole / world
                + acc) / 1e9
    moments = 8 * n / (world if stage >= 1 else 1)
    return (2 * n + 2 * n + moments + acc) / 1e9


def zero_nccl_times(by_name, count):
    """The card's ms and launches of the NCCL kernels in a trace, by kind."""
    out = {}
    for name, ms in by_name.items():
        if "nccl" not in name.lower():
            continue
        kind = next((v for k, v in NCCL_KINDS.items() if k in name), "other")
        rec = out.setdefault(kind, {"ms": 0.0, "launches": 0})
        rec["ms"] += ms
        rec["launches"] += count[name]
    return out


def param_checksums(engine):
    """Exact integer checksums of each parameter's bits (whole: gathered at
    stage 3), to hold ranks against each other without moving the
    tensors."""
    import torch

    out = []
    for p in engine.params.values():
        bits = p.detach().view(torch.int16 if p.element_size() == 2
                               else torch.int32)
        out.append(int(bits.sum(dtype=torch.int64)))
    return out


def update_rel_l2(got, want, start):
    """||got - want|| / ||want - start|| over every tensor (``got`` on the
    card, ``want`` and ``start`` on the host), one tensor at a time."""
    diff_sq = upd_sq = 0.0
    for name, g in got.items():
        w = want[name].to(g.device).float()
        s = start[name].to(g.device).float()
        diff_sq += float(((g.float() - w) ** 2).sum())
        upd_sq += float(((w - s) ** 2).sum())
    return (diff_sq / max(upd_sq, 1e-30)) ** 0.5


def bert_update_split(got, want, start):
    """``update_rel_l2`` of a BERT's parameters three ways: over every
    tensor (``all``), over all but the key third of each
    ``attention.qkv`` (its weight's rows C..2C and the same of its bias:
    ``without_key``) and over that key third alone (``key``). The tensors
    are compared on the card."""
    sums = {"all": [0.0, 0.0], "without_key": [0.0, 0.0], "key": [0.0, 0.0]}
    for name, g in got.items():
        g = g.to("cuda").float()
        w = want[name].to(g.device).float()
        s = start[name].to(g.device).float()
        d, u = (g - w) ** 2, (w - s) ** 2
        td, tu, kd, ku = float(d.sum()), float(u.sum()), 0.0, 0.0
        if name.endswith(("attention.qkv.weight", "attention.qkv.bias")):
            c = d.shape[0] // 3
            kd, ku = float(d[c:2 * c].sum()), float(u[c:2 * c].sum())
        for key, (a, b) in (("all", (td, tu)), ("key", (kd, ku)),
                            ("without_key", (td - kd, tu - ku))):
            sums[key][0] += a
            sums[key][1] += b
    return {k: (a / max(b, 1e-30)) ** 0.5 for k, (a, b) in sums.items()}


def zero_reference(ranks, batch):
    """The group-less one-card engine at gas = ``ranks`` on the first
    ``ranks`` ranks' rows of the global batch (``ranks`` micro batches of 4
    rows, in rank order): its losses and grad norms, and its initial and
    final parameters on the host. At ``ranks`` = world it is the reference;
    at world - 1 it is the control, the step of a run that dropped the
    last rank's rows."""
    import torch

    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    free_cuda()
    eng = gpt_1p3b_engine(config=zero_config(1, gas=ranks,
                                             comms_logger={}))
    start = {k: v.cpu() for k, v in eng.module.state_dict().items()}
    micro = [{k: v[r * 4:(r + 1) * 4] for k, v in batch.items()}
             for r in range(ranks)]
    losses, norms, times = train_steps(eng, iter(RepeatingLoader(micro)),
                                       STEPS)
    final = {k: v.cpu() for k, v in eng.module.state_dict().items()}
    out = {"losses": [float(x) for x in losses], "start": start,
           "final": final, "step_ms": times,
           "grad_norms": [float(x) for x in norms]}
    del eng
    free_cuda()
    torch.cuda.synchronize()
    return out


def time_b4_shard(n):
    """B4 over one rank's flat shard of ``n`` elements (bf16 p and g, f32 m
    and v: one tensor per dtype group, one launch). First held against its
    plain version as ``check_fused_adamw`` holds it over the leaves: 3 steps
    from the same device scalars on copies of p, m and v must agree bit for
    bit (the plain version runs on 64M-element views of the copies, so its
    temporaries fit beside them; it is elementwise, so the views change
    nothing), then a step with the skip flag set must change nothing. Then
    the kernel, its plain version and torch.optim.AdamW(fused=True) over f32
    copies, by the card's time."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import fused_adam as fadam

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(12)
    p = (torch.randn(n, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    g = (torch.randn(n, generator=gen, device=dev) * 1e-2).to(torch.bfloat16)
    m, v = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    before = fadam.launches
    p0 = p.clone()
    refs = [x.clone() for x in (p, m, v)]
    chunk = 1 << 26
    views = [list(x.split(chunk)) for x in (refs[0], g, refs[1], refs[2])]
    for step in (1, 2, 3):
        scalars = fadam.adamw_scalars(2e-4, step, 0.9, 0.95, dev)
        fadam.fused_adamw_apply([p], [g], [m], [v], scalars, **hyper)
        fadam.fused_adamw_reference(*views, scalars, **hyper)
    del views
    identical = {name: torch.equal(a, b)
                 for name, a, b in zip("pmv", (p, m, v), refs)}
    max_abs = float((p.float() - refs[0].float()).abs().max())
    moved = int((refs[0] != p0).sum()) / n
    del p0
    # the skip flag set: p, m and v must stay equal to the copies
    fadam.fused_adamw_apply([p], [g], [m], [v], fadam.adamw_scalars(
        2e-4, 4, 0.9, 0.95, dev, skip=True), **hyper)
    skip_untouched = all(torch.equal(a, b) for a, b in zip((p, m, v), refs))
    del refs
    torch.cuda.empty_cache()
    scalars = fadam.adamw_scalars(2e-4, 4, 0.9, 0.95, dev)

    def step():
        fadam.fused_adamw_apply([p], [g], [m], [v], scalars, **hyper)

    dev_t = device_ms(step, iters=10)
    plain_ms = device_ms(lambda: fadam.fused_adamw_reference(
        [p], [g], [m], [v], scalars, **hyper), iters=3, warmup=1)["ms"]
    fadam.launches = before  # a check and a timing, not a main path's launch
    del m, v
    p32 = torch.nn.Parameter(p.float())
    del p
    p32.grad = g.float()
    del g
    opt = torch.optim.AdamW([p32], lr=2e-4, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.1, fused=True)
    library_ms = device_ms(opt.step, iters=5, warmup=2)["ms"]
    del opt, p32
    torch.cuda.empty_cache()
    bound_ms, bound_by = _bound(16 * n, 22 * n, "float32")
    return {"elements": n, "steps": 3, "bit_identical": identical,
            "max_abs_err": max_abs, "p_moved_share": moved,
            "min_moved_share": ADAMW_MIN_MOVED,
            "skip_flag_leaves_all_unchanged": skip_untouched,
            "ms": dev_t["ms"], "device_time": dev_t,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "gb_per_s": 22 * n / dev_t["ms"] / 1e6}


def zero_yardstick(world):
    """One bare all-reduce of 2.63 GB (bf16) over every rank: the card's ms
    (CUDA events, median of 5 after 2) and the bus bandwidth, 2 (w-1) / w
    of the bytes over the time."""
    import torch

    from deepspeed_tpu_torch import comm

    buf = torch.ones(ZERO_YARDSTICK_BYTES // 2, dtype=torch.bfloat16,
                     device="cuda")
    times = []
    for i in range(7):
        comm.barrier()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        comm.all_reduce(buf)
        b.record()
        b.synchronize()
        if i >= 2:
            times.append(a.elapsed_time(b))
        buf.fill_(1.0)
    del buf
    torch.cuda.empty_cache()
    ms = statistics.median(times)
    factor = 2.0 * (world - 1) / world
    return {"bytes": ZERO_YARDSTICK_BYTES, "ms": ms, "ms_all": times,
            "bus_gb_per_s": factor * ZERO_YARDSTICK_BYTES / ms / 1e6}


def rel_errs(got, want):
    """Each step's relative error of ``got`` against ``want``."""
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def zero_traced_replay(engine, it):
    """One traced replay of a captured engine on every rank: the card's
    time, busy share, top kernels and the NCCL kernels' time by kind, with
    the bus bandwidth of each kind's wire bytes per replay (the comms
    logger's record of the graph)."""
    from deepspeed_tpu_torch import comm

    graphs = list(engine._fused.graphs.values())
    per_step = graphs[0].comms if graphs else {}
    # every rank starts the traced replay together: a collective's kernel
    # spins until the last rank arrives, and rank 0 may have just compared
    # its parameters with a reference
    comm.barrier()
    step, by_name, count = _trace(lambda: engine.train_batch(it))
    nccl = zero_nccl_times(by_name, count)
    for kind, rec in nccl.items():
        wire = per_step.get(kind, {}).get("wire_bytes", 0)
        rec["wire_bytes"] = wire
        rec["bus_gb_per_s"] = wire / rec["ms"] / 1e6 if rec["ms"] else None
    return ({k: {"count": v["count"], "bytes": v["bytes"],
                 "wire_bytes": v["wire_bytes"]} for k, v in per_step.items()},
            {"device_ms": step["device_ms"], "wall_ms": step["wall_ms"],
             "device_busy_share": step["device_busy_share"],
             "top_ms": step["top_ms"], "nccl": nccl})


def zero_stage_run(stage, world, batch, ref, control):
    """GPT-2 1.3B at ``stage`` on this rank: 12 captured steps against 12
    uncaptured ones (bit-identical), the launches per step, peak memory
    against the predicted state bytes, rank 0's agreement with the
    group-less reference and with the control, and a traced replay with
    the NCCL kernels' time and bus bandwidth."""
    import torch

    from deepspeed_tpu_torch.comm.logging import comms_logger

    extra = {}

    def make():
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        comms_logger.reset()
        return gpt_1p3b_engine(config=zero_config(stage))

    def inspect(engine, it):
        extra["checksums"] = param_checksums(engine)
        extra["comms_counters"] = comms_logger.counters()
        got = engine.params
        for key, other in (("vs_group_less", ref), ("vs_control", control)):
            if other is not None:
                extra[key] = {"update_rel_l2": update_rel_l2(
                    got, other["final"], other["start"])}
        del got
        extra["graph_comms_per_replay"], extra["traced_replay"] = \
            zero_traced_replay(engine, it)

    check, launches, losses, norms, times, e_losses, e_times = \
        captured_against_eager(make, [batch], STEPS, traced=inspect)
    ms, eager_ms = step_medians(times, e_times)
    out = {"stage": stage, "captured_vs_eager": check, "launches": launches,
           "losses": losses, "grad_norms": norms, "eager_losses": e_losses,
           "step_ms_median": ms, "eager_step_ms_median": eager_ms,
           "step_ms": times, "peak_allocated_gb": check["peak_allocated_gb"],
           "predicted_state_gb": zero_predicted_gb(stage, world)}
    out.update(extra)
    for key, other in (("vs_group_less", ref), ("vs_control", control)):
        if other is not None:
            by_step = rel_errs(norms, other["grad_norms"])
            out[key].update(
                loss_rel_err=max(rel_errs(losses, other["losses"])),
                grad_norm_rel_err=max(by_step),
                grad_norm_rel_err_by_step=by_step)
    return out


# BERT-Large under BigBird at 4096 (B5-B7) in the zero phase: stage 3 on
# every visible card, BERT_ZERO_ROWS rows of one global batch per step
# (``bert_zero_gas``: gas 4 at world 1, 1 at world 4), against the
# group-less engine at gas = the rows: each step's loss and grad norm
# within the zero phase's bounds, the first step's update within
# BERT_FIRST_UPDATE_REL_L2, and the 12-step update within
# BERT_WITNESS_FACTOR of the witness's. Every row holds the same count of
# labels (``mlm_batch``): with unequal counts the data-parallel engine's
# mean over the global batch's labelled tokens is not the mean of the
# micro batches' means that gradient accumulation takes (on four H100s,
# rows with 15% of their positions labelled at random put the first grad
# norm 1.9e-4 and the first update 0.17 off).
# The witness is the group-less engine against itself with its micro
# batches summed in the reverse order, run on rank 0 in the same call: a
# BERT run's 12-step update carries a rounding-level difference far, and
# the zero phase's GPT bound (ZERO_UPDATE_REL_L2) does not hold between two
# runs that differ in rounding alone. On an H100 the witness read a first
# update 3.4e-8 apart, losses within 1.8e-5, and a 12-step update 0.140
# apart: 0.543 over the key third of each attention.qkv (whose gradient
# sums to 0 over the keys, softmax ignoring a shift per row, so that
# rounding sets its direction along the tokens' common component; Adam
# turns it into steps of +-lr), 0.101 over the rest (PERF.md section 6).
# Stage 3 at world 4, whose exchange sums the ranks' bf16 gradients in
# bf16, read 0.173 with a first update 7.1e-7 apart, and at world 1 (gas
# 4) 0.174 with 7.1e-7. A fault in the
# exchange or the units moves the update by far more: the GPT's control
# (a run that lost one rank's rows) lay 0.74 off.
# On at least SIXB_MIN_WORLD cards also the int8 and 1-bit exchanges
# against the deferred f32 exchange: int8's every loss to GX_LOSS_REL_TOL
# and grad norm to BERT_GX_NORM_REL_TOL; 1-bit Adam (its exact norm on,
# tpu.compressed_grad_norm) ignores the clip, so only its first step, from
# the same weights, is held in loss and grad norm (the zero phase's
# first-step bounds), then its loss must fall over the run and after the
# freeze step
BERT_ZERO_ROWS = 4
BERT_WITNESS_FACTOR = 2.0


def bert_zero_gas(world):
    """The BERT stage-3 run's micro batches per step on ``world`` ranks:
    ``BERT_ZERO_ROWS`` rows in all (at least one per rank), so that the
    witness's gas (the rows) is the same at every world and its reversed
    order differs from the forward one (two micro batches would sum
    alike either way)."""
    return max(1, BERT_ZERO_ROWS // world)


BERT_GX_MODES = ("deferred_fp32", "int8_bucketed", "onebit")
BERT_GX_FREEZE_STEP = 4
# int8 rounds each 512-element block's values to 1/127 of its largest:
# the norm of the exchanged gradient moves by far less than that
BERT_GX_NORM_REL_TOL = 1e-2
# Adam's first update is lr * g / (|g| + eps), about lr * sign(g): a last-bit
# difference in a gradient moves no update unless the element's gradient
# lies within rounding of 0, and then by 2 lr. This bound allows ~80 such
# elements of BERT-Large's 339M (2 sqrt(k / N))
BERT_FIRST_UPDATE_REL_L2 = 1e-3


def zero_bert_config(stage, **over):
    config = dict(BERT_SPARSE_CONFIG, zero_optimization={"stage": stage},
                  comms_logger={"enabled": True})
    config.update(over)
    return config


def zero_bert_reference(batch, reverse=False):
    """The group-less BERT-Large engine at gas = the batch's rows, one row
    per micro batch in order (``reverse``: in the reverse order, which
    changes only the order in which the micro batches' gradients are
    summed): losses, grad norms, host copies of the initial parameters and
    of those after the first and the last step."""
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    rows = len(batch["input_ids"])
    free_cuda()
    eng = bert_large_engine(config=dict(BERT_SPARSE_CONFIG,
                                        gradient_accumulation_steps=rows))
    start = {k: v.to("cpu", copy=True)
             for k, v in eng.module.state_dict().items()}
    micro = [{k: v[r:r + 1] for k, v in batch.items()} for r in range(rows)]
    if reverse:
        micro.reverse()
    it = iter(RepeatingLoader(micro))
    losses, norms, times = train_steps(eng, it, 1)
    first = {k: v.to("cpu", copy=True)
             for k, v in eng.module.state_dict().items()}
    more = train_steps(eng, it, STEPS - 1)
    losses, norms, times = losses + more[0], norms + more[1], times + more[2]
    out = {"losses": [float(x) for x in losses],
           "grad_norms": [float(x) for x in norms], "step_ms": times,
           "start": start, "first": first,
           "final": {k: v.to("cpu", copy=True)
             for k, v in eng.module.state_dict().items()}}
    del eng
    free_cuda()
    return out


def zero_bert_stage3(world, batch, ref):
    """BERT-Large sparse at stage 3 on this rank (its layers the units),
    ``bert_zero_gas(world)`` micro batches of one row per step (global
    micro batch j: rows j w .. j w + w - 1): 12 captured steps against 12
    uncaptured ones, the launches (B5 48 / B6 24 / B7 24 per micro batch,
    B4 1 per step), rank 0's agreement with the group-less engine, and a
    traced replay."""
    import torch

    from deepspeed_tpu_torch.comm.logging import comms_logger

    extra, probed = {}, []
    gas = bert_zero_gas(world)
    micro = [{k: v[j * world:(j + 1) * world] for k, v in batch.items()}
             for j in range(gas)]

    def make():
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        comms_logger.reset()
        return bert_large_engine(config=zero_bert_config(
            3, gradient_accumulation_steps=gas))

    def probe(engine):
        # before the captured run's second step: its parameters after the
        # first (a gather: every rank calls it)
        probed.append(None)
        if len(probed) == 2:
            got = engine.params
            if ref is not None:
                extra["first_step_update_rel_l2"] = update_rel_l2(
                    got, ref["first"], ref["start"])
            del got

    def inspect(engine, it):
        extra["checksums"] = param_checksums(engine)
        extra["units"] = [u.name for u in engine.optimizer.units]
        got = engine.params
        if ref is not None:
            # and the tensors whose updates part the most from the
            # reference's (their share of the squared difference)
            diff = {}
            for name, g in got.items():
                w = ref["final"][name].to(g.device).float()
                diff[name] = float(((g.float() - w) ** 2).sum())
            total = sum(diff.values()) or 1.0
            split = bert_update_split(got, ref["final"], ref["start"])
            extra["vs_group_less"] = {
                "update_rel_l2": split["all"],
                "update_rel_l2_without_key": split["without_key"],
                "update_rel_l2_key": split["key"],
                "update_diff_share_top": sorted(
                    ((v / total, k) for k, v in diff.items()),
                    reverse=True)[:6]}
        del got
        extra["graph_comms_per_replay"], extra["traced_replay"] = \
            zero_traced_replay(engine, it)

    check, launches, losses, norms, times, e_losses, e_times = \
        captured_against_eager(make, micro, STEPS, traced=inspect,
                               probe=probe)
    ms, eager_ms = step_medians(times, e_times)
    out = {"gas": gas, "captured_vs_eager": check, "launches": launches,
           "losses": losses, "grad_norms": norms, "eager_losses": e_losses,
           "step_ms_median": ms, "eager_step_ms_median": eager_ms,
           "step_ms": times, "peak_allocated_gb": check["peak_allocated_gb"]}
    first_update = extra.pop("first_step_update_rel_l2", None)
    out.update(extra)
    if ref is not None:
        by_step = rel_errs(norms, ref["grad_norms"])
        out["vs_group_less"]["first_step_update_rel_l2"] = first_update
        out["vs_group_less"].update(
            loss_rel_err=max(rel_errs(losses, ref["losses"])),
            grad_norm_rel_err=max(by_step),
            grad_norm_rel_err_by_step=by_step)
    return out


def zero_bert_exchanges(world, batch):
    """BERT-Large sparse under each of ``BERT_GX_MODES`` at stage 0 on this
    rank (every rank runs every mode): 12 captured steps each, their
    losses, grad norms, launches, step ms and peak."""
    import torch

    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    out = {}
    for mode in BERT_GX_MODES:
        tpu = dict(BERT_SPARSE_CONFIG["tpu"])
        over = {}
        if mode == "deferred_fp32":
            tpu["grad_exchange"] = {"deferred": True,
                                    "bucket_mb": GX_BUCKET_MB,
                                    "wire_dtype": "fp32"}
        elif mode == "int8_bucketed":
            tpu["grad_exchange"] = {"bucket_mb": GX_BUCKET_MB}
            over["communication_data_type"] = "int8"
        else:
            tpu["compressed_grad_norm"] = True
            over["optimizer"] = {"type": "OneBitAdam", "params": dict(
                BERT_SPARSE_CONFIG["optimizer"]["params"],
                freeze_step=BERT_GX_FREEZE_STEP)}
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        engine = bert_large_engine(config=zero_bert_config(0, tpu=tpu,
                                                            **over))
        losses, norms, times = train_steps(
            engine, iter(RepeatingLoader([batch])), STEPS)
        out[mode] = {"engine_mode": engine._cx_mode,
                     "launches": read_launches(),
                     "losses": [float(x) for x in losses],
                     "grad_norms": [None if x is None else float(x)
                                    for x in norms],
                     "step_ms_median": statistics.median(
                         times[CAPTURE_WARMUP + 1:]),
                     "peak_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9,
                     "checksums": param_checksums(engine)}
        del engine
    free_cuda()
    return out


def zero_bert_report(world, results, smi):
    """The BERT lines of the zero phase; returns the failed checks and rank
    0's stage-3 launches."""
    problems = []
    runs = [r["bert_stage3"] for r in results]
    lead = runs[0]
    vs = lead["vs_group_less"]
    witness = results[0]["bert_witness"]
    emit({"phase": "zero", "part": "bert_stage3", "world": world,
          "card": smi, "model": "bert-large", "batch_per_rank": [1, SPARSE_SEQ],
          "sparse_attention": BIGBIRD_BLOCK, "steps": STEPS,
          "units": lead["units"], "losses": lead["losses"],
          "group_less_losses": results[0]["bert_reference"]["losses"],
          "vs_group_less": vs,
          "gas": lead["gas"],
          "witness_group_less_reversed": witness,
          "tolerance": {"loss_rel": ZERO_LOSS_REL_TOL,
                        "first_step_update_rel_l2": BERT_FIRST_UPDATE_REL_L2,
                        "update_rel_l2": BERT_WITNESS_FACTOR
                        * witness["update"]["all"],
                        "grad_norm_rel_first_step":
                            ZERO_GRAD_NORM_FIRST_REL_TOL,
                        "grad_norm_rel": ZERO_GRAD_NORM_REL_TOL},
          "step_ms_median_by_rank": [r["step_ms_median"] for r in runs],
          "eager_step_ms_median_by_rank": [r["eager_step_ms_median"]
                                           for r in runs],
          "group_less_step_ms_median": statistics.median(
              results[0]["bert_reference"]["step_ms"][CAPTURE_WARMUP + 1:]),
          "peak_allocated_gb_by_rank": [r["peak_allocated_gb"] for r in runs],
          "captured_vs_eager_by_rank": [r["captured_vs_eager"]["identical"]
                                        for r in runs],
          "launches_rank0": lead["launches"],
          "graph_comms_per_replay": lead["graph_comms_per_replay"],
          "traced_replay_by_rank": [r["traced_replay"] for r in runs]})
    if not all(r["captured_vs_eager"]["identical"] for r in runs):
        problems.append("bert stage 3: captured and eager steps differ")
    if any(r["losses"] != lead["losses"] or r["checksums"] != lead["checksums"]
           for r in runs):
        problems.append("bert stage 3: ranks differ")
    for r in runs:
        for name, per in SPARSE_PER_STEP.items():
            per *= 1 if name == "fused_adamw" else r["gas"]
            if r["launches"][name] != per * STEPS:
                problems.append(f"bert stage 3: {name} launched "
                                f"{r['launches'][name]}, want {per} x {STEPS}")
    if len(lead["units"]) != 25:
        problems.append(f"bert stage 3 units: {lead['units']}")
    if not lead["losses"][-1] <= lead["losses"][0] - SPARSE_MIN_LOSS_DROP:
        problems.append("bert stage 3: the loss did not fall")
    if not (vs["loss_rel_err"] <= ZERO_LOSS_REL_TOL
            and vs["first_step_update_rel_l2"] <= BERT_FIRST_UPDATE_REL_L2
            and vs["update_rel_l2"]
            <= BERT_WITNESS_FACTOR * witness["update"]["all"]
            and vs["grad_norm_rel_err_by_step"][0]
            <= ZERO_GRAD_NORM_FIRST_REL_TOL
            and vs["grad_norm_rel_err"] <= ZERO_GRAD_NORM_REL_TOL):
        problems.append(f"bert stage 3 against the group-less engine: {vs}")
    if world < SIXB_MIN_WORLD:
        return problems, lead["launches"]
    gx = [r["bert_exchanges"] for r in results]
    ref = gx[0]["deferred_fp32"]
    for mode in BERT_GX_MODES:
        run = gx[0][mode]
        line = {"phase": "zero", "part": "bert_grad_exchange", "mode": mode,
                "world": world, "card": smi, "model": "bert-large",
                "batch_per_rank": [1, SPARSE_SEQ], "steps": STEPS, **run,
                "step_ms_median_by_rank": [g[mode]["step_ms_median"]
                                           for g in gx]}
        if mode != "deferred_fp32":
            line["vs_deferred_fp32"] = {
                "loss_rel_err_by_step": rel_errs(run["losses"],
                                                 ref["losses"]),
                "grad_norm_rel_err_by_step": [
                    None if a is None else abs(a - b) / abs(b)
                    for a, b in zip(run["grad_norms"], ref["grad_norms"])]}
        emit(line)
        if any(g[mode]["losses"] != run["losses"]
               or g[mode]["checksums"] != run["checksums"] for g in gx):
            problems.append(f"bert {mode}: ranks differ")
        want = {"deferred_fp32": "deferred", "int8_bucketed": "int8",
                "onebit": "onebit"}[mode]
        if run["engine_mode"] != want:
            problems.append(f"bert {mode}: the engine took "
                            f"{run['engine_mode']}")
        for name, per in SPARSE_PER_STEP.items():
            per = 0 if (mode == "onebit" and name == "fused_adamw") else per
            if run["launches"][name] != per * STEPS:
                problems.append(f"bert {mode}: {name} launched "
                                f"{run['launches'][name]}")
        if not run["losses"][-1] < run["losses"][0]:
            problems.append(f"bert {mode}: the loss did not fall")
        if mode == "int8_bucketed":
            vs = line["vs_deferred_fp32"]
            if not (max(vs["loss_rel_err_by_step"]) <= GX_LOSS_REL_TOL
                    and max(vs["grad_norm_rel_err_by_step"])
                    <= BERT_GX_NORM_REL_TOL):
                problems.append(f"bert int8 against deferred f32: {vs}")
        if mode == "onebit":
            vs = line["vs_deferred_fp32"]
            if not (vs["loss_rel_err_by_step"][0] <= ZERO_LOSS_REL_TOL
                    and vs["grad_norm_rel_err_by_step"][0]
                    <= ZERO_GRAD_NORM_FIRST_REL_TOL):
                problems.append(f"bert onebit's first step against deferred "
                                f"f32: {vs}")
            if not run["losses"][-1] < run["losses"][BERT_GX_FREEZE_STEP - 1]:
                problems.append("bert onebit: the loss did not fall after "
                                "the freeze step")
    return problems, lead["launches"]


def zero_6p7b_pair(world, rank):
    """GPT-2 6.7B at micro ``SIXB_MICRO`` x 1024 per rank (bf16, full remat,
    flash, ``GPT_PRETRAIN_CONFIG``), on ``world`` >= 4 cards: 12 captured
    steps at stage 2, then 12 captured steps at stage 3 against 12
    uncaptured ones; each with its launches, step ms, peak memory against
    the predicted state and a traced replay. Rank 0 holds stage 3's losses
    and final parameters against stage 2's (the updates from the same
    initial weights); every rank computes every gather (a collective)."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.comm.logging import comms_logger
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    rng = np.random.RandomState(2)
    ids = rng.randint(0, 50257, size=(SIXB_MICRO * world, 1024)).astype(
        np.int64)
    batch = {"input_ids": ids, "labels": ids}
    config = {stage: zero_config(stage, train_micro_batch_size_per_gpu=
                                 SIXB_MICRO) for stage in (2, 3)}

    def make(stage):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        comms_logger.reset()
        return gpt_1p3b_engine(config=config[stage], model="gpt2-6.7b")

    def host(sd):
        return {k: v.to("cpu", copy=True) for k, v in sd.items()}

    out = {}
    # stage 2: captured only (its state and an uncaptured twin's would not
    # fit on a card one after the other in the time asked)
    reset_launches()
    eng = make(2)
    start = host(eng.params) if rank == 0 else None
    it = iter(RepeatingLoader([batch]))
    losses, norms, times = train_steps(eng, it, STEPS)
    launches = read_launches()
    two = {"losses": [float(x) for x in losses],
           "grad_norms": [float(x) for x in norms], "launches": launches,
           "step_ms": times,
           "step_ms_median": statistics.median(times[CAPTURE_WARMUP + 1:]),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "predicted_state_gb": zero_predicted_gb(2, world,
                                                   model="gpt2-6.7b"),
           "checksums": param_checksums(eng)}
    final2 = host(eng.params) if rank == 0 else None
    two["graph_comms_per_replay"], two["traced_replay"] = \
        zero_traced_replay(eng, it)
    del eng, it
    out[2] = two
    extra = {}

    def inspect(engine, it):
        extra["checksums"] = param_checksums(engine)
        got = engine.params
        if rank == 0:
            extra["update_rel_l2_vs_stage2"] = update_rel_l2(got, final2,
                                                             start)
        del got
        extra["graph_comms_per_replay"], extra["traced_replay"] = \
            zero_traced_replay(engine, it)

    check, launches, losses, norms, times, e_losses, e_times = \
        captured_against_eager(lambda: make(3), [batch], STEPS,
                               traced=inspect)
    ms, eager_ms = step_medians(times, e_times)
    three = {"captured_vs_eager": check, "launches": launches,
             "losses": losses, "grad_norms": norms, "eager_losses": e_losses,
             "step_ms": times, "step_ms_median": ms,
             "eager_step_ms_median": eager_ms,
             "peak_allocated_gb": check["peak_allocated_gb"],
             "predicted_state_gb": zero_predicted_gb(3, world,
                                                     model="gpt2-6.7b")}
    three.update(extra)
    three["loss_rel_err_vs_stage2"] = max(rel_errs(losses, two["losses"]))
    three["grad_norm_rel_err_vs_stage2_by_step"] = rel_errs(
        norms, two["grad_norms"])
    out[3] = three
    del start, final2
    free_cuda()
    return out


# ---------------------------------------------------------------------------
# the gradient exchanges (the grad_exchange part of the zero phase)
# ---------------------------------------------------------------------------
# GPT-2 1.3B at gas 2 under each exchange: (a) the deferred bucketed
# exchange at a bf16 wire (the main path; at world 1 the JAX engine, and so
# the port, takes the plain stage-0 step: there is no dp axis to defer
# over) and at an f32 wire (the reference of the others), (b) int8 in 4 MB
# buckets, (c) 1-bit Adam with freeze_step 4 (steps 1-4 the exact warm-up,
# then compressed: two graphs), and the stage-0 engine with an f32 exchange
# (the one (a) at f32 is held to: the same sums in another order)
GX_GAS = 2
GX_BUCKET_MB = 4
GX_FREEZE_STEP = 4
GX_MODES = ("deferred_bf16", "deferred_fp32", "int8_bucketed", "onebit")
# (a) at f32 against the stage-0 engine's f32 exchange, where the two
# differ only in the order of their f32 sums: the first step's update to
# this relative L2, and the first grad norm to the zero phase's first-step
# bound. Over the 12 steps the bf16 parameters round a last-bit difference
# of an update into a whole bf16 step of some parameters, and those
# compound: on four cards the 12-step update read 0.0036 (loss 1.0e-5),
# so the run is held to the zero phase's bounds
GX_FP32_UPDATE_REL_L2 = 1e-5
# the others against (a) at f32, the CPU tests' convergence bounds: each
# step's loss to 1e-3 relative (bf16 wire), the same for int8, whose
# updates differ by the quantisation. 1-bit Adam ignores the clip (the
# JAX warning) from its first step, and after its freeze step is another
# update rule: it is held to convergence, the loss falling over the run
# and after the freeze step (its distance to (a) is printed)
GX_LOSS_REL_TOL = 1e-3
# the elements of the kernel-level checks: one 4 MB bucket
GX_CHECK_ELEMENTS = 1 << 20
GX_PER_STEP = {"flash_attention_fwd": 48 * GX_GAS,
               "flash_attention_bwd_dq": 24 * GX_GAS,
               "flash_attention_bwd_dkv": 24 * GX_GAS}


def gx_config(mode):
    """``GPT_PRETRAIN_CONFIG`` at stage 0 and gas 2 with the exchange of
    ``mode``, the comms logger on."""
    config = zero_config(0, gas=GX_GAS)
    tpu = dict(GPT_PRETRAIN_CONFIG["tpu"])
    if mode.startswith("deferred"):
        tpu["grad_exchange"] = {"deferred": True, "bucket_mb": GX_BUCKET_MB,
                                "wire_dtype": mode.split("_")[1]}
    elif mode == "int8_bucketed":
        tpu["grad_exchange"] = {"bucket_mb": GX_BUCKET_MB}
        config["communication_data_type"] = "int8"
    elif mode == "onebit":
        params = dict(GPT_PRETRAIN_CONFIG["optimizer"]["params"],
                      freeze_step=GX_FREEZE_STEP)
        config["optimizer"] = {"type": "OneBitAdam", "params": params}
    elif mode == "stage0_fp32":
        config["communication_data_type"] = "fp32"
    config["tpu"] = tpu
    return config


def gx_predicted_wire_gb(mode, world, n=GPT_1P3B_PARAMS, warmup=False):
    """The wire bytes per step and rank the exchange should log, ring
    accounting: an all-reduce of b bytes sends 2 (w-1)/w b."""
    ring = 2 * (world - 1) / world
    padded = n + (-n) % (world * 512)
    per = {"stage0_bf16": GX_GAS * ring * 2 * n,
           "stage0_fp32": GX_GAS * ring * 4 * n,
           "deferred_bf16": ring * 2 * n, "deferred_fp32": ring * 4 * n,
           "int8_bucketed": ring * padded * (1 + 4 / 512),
           "onebit": ring * 4 * n if warmup else ring * n}
    return per[mode] / 1e9


def gx_predicted_state_gb(mode, world, n=GPT_1P3B_PARAMS):
    """State bytes per rank: bf16 parameters (2N), f32 moments (8N), the
    f32 per-worker gradient sum (4N) and, for int8 and 1-bit, the worker
    (4N) and server (4N / w) error feedback."""
    state = 2 * n + 8 * n + 4 * n
    if mode in ("int8_bucketed", "onebit"):
        state += 4 * n + 4 * n / world
    return state / 1e9


def _bits_sum(tensors):
    import torch

    return int(sum(int(t.detach().view(torch.int32).sum(dtype=torch.int64))
                   for t in tensors))


def gx_exchange_checksums(engine):
    cx = engine._cx
    if cx is None:
        return None
    return [_bits_sum(cx.worker_error), _bits_sum(cx.server_error)]


def gx_mode_run(mode, world, batch, captured_only=False):
    """GPT-2 1.3B under ``mode`` on this rank: 12 captured steps, then (but
    ``captured_only``) 12 uncaptured ones from the same seed; the launches,
    step ms, peak memory, the error feedback's checksums, a traced replay
    (NCCL card ms by kind) with the comms logger's records of that step."""
    import torch

    from deepspeed_tpu_torch.comm.logging import comms_logger
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    extra = {}

    def make():
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        comms_logger.reset()
        return gpt_1p3b_engine(config=gx_config(mode))

    def inspect(engine, it):
        extra["checksums"] = param_checksums(engine)
        extra["exchange_checksums"] = gx_exchange_checksums(engine)
        extra["mode"] = engine._cx_mode
        extra["graphs"] = {name: len(getattr(engine, name).graphs)
                           for name in ("_micro", "_apply")}
        extra["final"] = ({k: v.to("cpu", copy=True)
                           for k, v in engine.params.items()}
                          if comm_rank() == 0 else None)
        from deepspeed_tpu_torch import comm

        comm.barrier()
        comms_logger.reset()
        step, by_name, count = _trace(lambda: engine.train_batch(it))
        extra["comms_per_step"] = comms_logger.snapshot()
        extra["nccl"] = zero_nccl_times(by_name, count)
        extra["traced_replay"] = {k: step[k] for k in (
            "device_ms", "wall_ms", "device_busy_share", "top_ms")}

    if captured_only:
        reset_launches()
        engine = make()
        it = iter(RepeatingLoader([batch]))
        losses, norms, times = train_steps(engine, it, STEPS)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
        inspect(engine, it)
        del engine, it
        free_cuda()
        return dict(extra, launches=launches, peak_allocated_gb=peak,
                    losses=[float(x) for x in losses], step_ms=times,
                    grad_norms=[float(x) for x in norms],
                    step_ms_median=statistics.median(
                        times[CAPTURE_WARMUP + 1:]))
    check, launches, losses, norms, times, e_losses, e_times = \
        captured_against_eager(make, [batch], STEPS, traced=inspect)
    ms, eager_ms = step_medians(times, e_times)
    return dict(extra, captured_vs_eager=check, launches=launches,
                losses=losses, grad_norms=norms, eager_losses=e_losses,
                step_ms=times, step_ms_median=ms,
                eager_step_ms_median=eager_ms,
                peak_allocated_gb=check["peak_allocated_gb"])


def comm_rank():
    from deepspeed_tpu_torch import comm

    return comm.get_rank()


def gx_check_collectives(world, rank):
    """The card's ``quantized_all_reduce`` and ``compressed_allreduce``
    against their plain single-process simulation on the same card: every
    rank's input gathered, each rank's copy quantized (signed) as that rank
    does it, summed in rank order. Returns the comparison and the ms of
    each collective (CUDA events, median of 5)."""
    import torch

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm.compressed import (quantized_all_reduce,
                                                     server_shard_length)
    from deepspeed_tpu_torch.ops.quantizer import (dequantize,
                                                   quantize_blockwise)
    from deepspeed_tpu_torch.runtime.fp16.onebit.adam import (
        _compress, compressed_allreduce)

    from deepspeed_tpu_torch.parallel.mesh import (MeshTopology,
                                                   set_default_topology)

    # the collectives run over dp (the earlier stage runs left fsdp)
    set_default_topology(MeshTopology(dp=world))
    n, block = GX_CHECK_ELEMENTS - 1000, 512
    gen = torch.Generator(device="cuda").manual_seed(40 + rank)
    x = torch.randn(n, generator=gen, device="cuda") * 1e-3
    per = server_shard_length(n, world, block)
    se = torch.randn(per, generator=gen, device="cuda") * 1e-6
    out, err, new_se = quantized_all_reduce(x, "dp", block=block,
                                            return_error=True,
                                            server_error=se)
    xs = comm.all_gather(x, "dp").view(world, n)
    ses = comm.all_gather(se, "dp").view(world, per)
    pad = world * per - n
    flat = torch.nn.functional.pad(xs, (0, pad))
    q, s = zip(*[quantize_blockwise(f, block) for f in flat])
    shards = []
    for j in range(world):
        acc = dequantize(q[0][j * per:(j + 1) * per],
                         s[0][j * per // block:(j + 1) * per // block])
        for r in range(1, world):
            acc = acc + dequantize(q[r][j * per:(j + 1) * per],
                                   s[r][j * per // block:
                                        (j + 1) * per // block])
        shards.append(acc + ses[j])
    q2 = [quantize_blockwise(sh, block) for sh in shards]
    sim = torch.cat([dequantize(a, b) for a, b in q2])[:n]
    sim_err = (flat[rank] - dequantize(q[rank], s[rank]))[:n]
    sim_se = shards[rank] - dequantize(*q2[rank])
    int8 = {"out_identical": bool(torch.equal(out, sim)),
            "worker_error_identical": bool(torch.equal(err, sim_err)),
            "server_error_identical": bool(torch.equal(new_se, sim_se)),
            "max_abs_diff": float((out - sim).abs().max()),
            "one_step": float(max(b.max() for b in
                                  (q2[j][1] for j in range(world))))}
    int8["equal_share"] = float((out == sim).float().mean())
    # 1-bit: the padded momentum of one leaf, worker and server residuals
    k = world
    m = n + (-n) % k
    xm = torch.nn.functional.pad(x, (0, m - n))
    we = torch.randn(m, generator=gen, device="cuda") * 1e-4
    we[n:] = 0
    se1 = torch.randn(m // k, generator=gen, device="cuda") * 1e-5
    res, we2, se2 = compressed_allreduce(xm, we, se1, "dp", n_valid=n)
    xms = comm.all_gather(xm, "dp").view(k, m)
    wes = comm.all_gather(we, "dp").view(k, m)
    ses1 = comm.all_gather(se1, "dp").view(k, m // k)
    comp = [_compress(xms[r].clone(), wes[r], n if m > n else None)
            for r in range(k)]
    chunk = m // k
    sim_chunks = []
    for j in range(k):
        acc = comp[0][0][j * chunk:(j + 1) * chunk].float() * comp[0][1]
        for r in range(1, k):
            acc = acc + (comp[r][0][j * chunk:(j + 1) * chunk].float()
                         * comp[r][1])
        valid = min(max(n - j * chunk, 0), chunk)
        sim_chunks.append(_compress(acc / k, ses1[j],
                                    valid if m > n else None))
    sim_res = torch.cat([sg.float() * sc for sg, sc, _ in sim_chunks])
    onebit = {"out_identical": bool(torch.equal(res, sim_res)),
              "worker_error_identical": bool(torch.equal(we2, comp[rank][2])),
              "server_error_identical": bool(torch.equal(
                  se2, sim_chunks[rank][2])),
              "max_abs_diff": float((res - sim_res).abs().max()),
              "equal_share": float((res == sim_res).float().mean()),
              "one_step": float(2 * max(sc for _, sc, _ in sim_chunks))}

    def timed_ms(fn):
        times = []
        for _ in range(7):
            comm.barrier()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times[2:])

    int8["ms"] = timed_ms(lambda: quantized_all_reduce(
        x, "dp", block=block, return_error=True, server_error=se))
    onebit["ms"] = timed_ms(lambda: compressed_allreduce(
        xm, we, se1, "dp", n_valid=n))
    return {"elements": n, "int8": int8, "onebit": onebit}


def gx_runs(world, rank, batch, ref, control):
    """The gradient exchanges at 1.3B on this rank (every rank runs every
    collective), and rank 0's comparisons: (a) at f32 against the stage-0
    engine's f32 exchange, the others' losses against (a) at f32, and the
    control's (the group-less engine without the last rank's rows, at
    world > 1)."""
    out = {"check": gx_check_collectives(world, rank)}
    free_cuda()
    out["small"] = gx_small_runs(world)
    stage0 = gx_mode_run("stage0_fp32", world, batch, captured_only=True)
    for mode in GX_MODES:
        out[mode] = gx_mode_run(mode, world, batch)
    first = gx_first_steps(batch, rank)
    if rank == 0:
        fp32 = out["deferred_fp32"]
        start = ref["start"]

        def rel_l2(got, want):
            return update_rel_l2({k: v.to("cuda") for k, v in got.items()},
                                 want, start)
        out["deferred_fp32"]["vs_stage0_fp32"] = {
            "first_step_update_rel_l2": rel_l2(first["deferred_fp32"],
                                               first["stage0_fp32"]),
            "update_rel_l2": rel_l2(fp32["final"], stage0["final"]),
            "loss_rel_err": max(rel_errs(fp32["losses"], stage0["losses"])),
            "grad_norm_rel_err_by_step": rel_errs(fp32["grad_norms"],
                                                  stage0["grad_norms"])}
        for mode in GX_MODES:
            run = out[mode]
            run["vs_deferred_fp32"] = {
                "loss_rel_err": max(rel_errs(run["losses"],
                                             fp32["losses"])),
                "update_rel_l2": rel_l2(run["final"], fp32["final"])}
        if control is not None:
            out["control"] = {
                "loss_rel_err": max(rel_errs(control["losses"],
                                             fp32["losses"])),
                "update_rel_l2": rel_l2(control["final"], fp32["final"])}
    del first
    for mode in GX_MODES:
        out[mode].pop("final", None)
    out["stage0_fp32"] = {k: v for k, v in stage0.items() if k != "final"}
    return out


def gx_first_steps(batch, rank):
    """The parameters after one step of (a) at f32 and of the stage-0
    engine's f32 exchange from the same weights (on rank 0's host; every
    rank steps): where the two differ only in the order of their f32
    sums. Over 12 steps the bf16 parameters turn last-bit differences of
    an update into whole bf16 steps of some parameters, which compound."""
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    out = {}
    for mode in ("stage0_fp32", "deferred_fp32"):
        free_cuda()
        engine = gpt_1p3b_engine(config=gx_config(mode))
        engine.train_batch(iter(RepeatingLoader([batch])))
        out[mode] = ({k: v.to("cpu", copy=True)
                      for k, v in engine.params.items()} if rank == 0
                     else None)
        del engine
    free_cuda()
    return out


def gx_small_runs(world):
    """(d) on small bf16 GPTs, captured against eager: 1-bit LAMB across
    its freeze step, 0/1 Adam across refresh and plain steps, and at an
    even world above 1 the hierarchical deferred exchange over 2 slices
    (``dcn_slices``; its sub-groups warmed before the capture)."""
    import torch

    out = {}
    batches = zero_small_batches(world, 2, seed=13)
    runs = {"onebit_lamb": {"optimizer": {"type": "OneBitLamb", "params": {
                "lr": SMALL_LR, "weight_decay": 0.1, "freeze_step": 3}}},
            # at lr 1e-3 (and on four cards at 1e-4) 0/1 Adam's first
            # sign-compressed steps over a variance from one gradient throw
            # the small model off (as in the CPU tests)
            "zero_one_adam": {"optimizer": {"type": "ZeroOneAdam", "params": {
                "lr": SMALL_LR / 100, "weight_decay": 0.1,
                "var_update_period": 3}}}}
    if world > 1 and world % 2 == 0:
        runs["hierarchical"] = {"tpu": {
            "use_pallas_optimizer": True, "grad_exchange": {
                "deferred": True, "hierarchical": "on", "dcn_slices": 2,
                "bucket_mb": 0.5}}}
    for name, over in runs.items():
        check, launches, losses, _, _, e_losses, _ = captured_against_eager(
            lambda over=over: zero_small_engine(0, torch.bfloat16, over,
                                                gas=2), batches, 8)
        out[name] = {"captured_vs_eager": check, "launches": launches,
                     "losses": losses, "eager_losses": e_losses}
    return out


def gx_report(world, results, smi):
    """One JSON line per exchange mode, one for the collectives' checks;
    returns the failed checks and rank 0's launches of (a)."""
    problems = []
    r0 = results[0]["grad_exchange"]
    check = [r["grad_exchange"]["check"] for r in results]
    emit({"phase": "zero", "part": "grad_exchange_collectives",
          "world": world, "card": smi, "by_rank": check})
    small = [r["grad_exchange"]["small"] for r in results]
    emit({"phase": "zero", "part": "grad_exchange_small", "world": world,
          "rank0": small[0]})
    for r in small:
        for name, run in r.items():
            if not run["captured_vs_eager"]["identical"]:
                problems.append(f"small {name}: captured and eager differ")
            if not all(math.isfinite(x) for x in run["losses"]):
                problems.append(f"small {name}: a loss is not finite")
    for c in check:
        for kind in ("int8", "onebit"):
            got = c[kind]
            if not (got["out_identical"] and got["worker_error_identical"]
                    and got["server_error_identical"]):
                if not got["max_abs_diff"] <= got["one_step"]:
                    problems.append(f"{kind} collective against its "
                                    f"simulation: {got}")
    n = GPT_1P3B_PARAMS
    for mode in GX_MODES + ("stage0_fp32",):
        runs = [r["grad_exchange"][mode] for r in results]
        lead = runs[0]
        wire = {k: v["wire_bytes"] for k, v in lead["comms_per_step"].items()}
        line = {"phase": "zero", "part": "grad_exchange", "mode": mode,
                "engine_mode": lead["mode"], "world": world, "card": smi,
                "model": "gpt2-1.3b", "batch_per_rank": [4, 1024],
                "gas": GX_GAS, "steps": STEPS, "losses": lead["losses"],
                "step_ms_median_by_rank": [r.get("step_ms_median")
                                           for r in runs],
                "eager_step_ms_median_by_rank": [
                    r.get("eager_step_ms_median") for r in runs],
                "nccl_by_rank": [r["nccl"] for r in runs],
                "traced_replay_rank0": lead["traced_replay"],
                "wire_gb_per_step_logged": sum(wire.values()) / 1e9,
                "wire_by_name": wire,
                "wire_gb_per_step_predicted": (
                    gx_predicted_wire_gb(mode, world)
                    if mode != "stage0_fp32" else
                    gx_predicted_wire_gb("stage0_fp32", world)),
                "wire_gb_per_step_predicted_stage0_bf16":
                    gx_predicted_wire_gb("stage0_bf16", world),
                "peak_allocated_gb_by_rank": [r["peak_allocated_gb"]
                                              for r in runs],
                "predicted_state_gb": gx_predicted_state_gb(mode, world),
                "launches_rank0": lead["launches"],
                "graphs": lead["graphs"],
                "captured_vs_eager_by_rank": [
                    r.get("captured_vs_eager", {}).get("identical")
                    for r in runs],
                "vs_deferred_fp32": lead.get("vs_deferred_fp32"),
                "vs_stage0_fp32": lead.get("vs_stage0_fp32"),
                "control_vs_deferred_fp32": r0.get("control"),
                "tolerance": {"fp32_vs_stage0_update_rel_l2":
                              GX_FP32_UPDATE_REL_L2,
                              "loss_rel": GX_LOSS_REL_TOL}}
        emit(line)
        if mode == "stage0_fp32":
            continue
        if not all(r["captured_vs_eager"]["identical"] for r in runs):
            problems.append(f"{mode}: captured and eager steps differ")
        if any(r["losses"] != lead["losses"] for r in runs):
            problems.append(f"{mode}: ranks returned other losses")
        if any(r["checksums"] != lead["checksums"] for r in runs):
            problems.append(f"{mode}: ranks hold other parameters")
        want = dict(GX_PER_STEP, fused_adamw=0 if mode == "onebit" else 1)
        for r in runs:
            for name, per in want.items():
                if r["launches"][name] != per * STEPS:
                    problems.append(f"{mode}: {name} launched "
                                    f"{r['launches'][name]}, want "
                                    f"{per} x {STEPS}")
        if not lead["losses"][-1] <= lead["losses"][0] - TRAIN_MIN_LOSS_DROP:
            problems.append(f"{mode}: the loss did not fall")
        expect_mode = {"deferred_bf16": "deferred", "deferred_fp32":
                       "deferred", "int8_bucketed": "int8",
                       "onebit": "onebit"}[mode]
        if lead["mode"] != (expect_mode if world > 1 or mode in (
                "int8_bucketed", "onebit") else None):
            problems.append(f"{mode}: the engine took {lead['mode']}")
        if mode == "onebit" and lead["graphs"]["_apply"] != 2:
            problems.append(f"onebit: {lead['graphs']} graphs, want 2 "
                            "apply graphs (warm-up and compressed)")
        vs = lead["vs_deferred_fp32"]
        if mode in ("deferred_bf16", "int8_bucketed") and not \
                vs["loss_rel_err"] <= GX_LOSS_REL_TOL:
            problems.append(f"{mode} against (a) at f32: {vs}")
        if mode == "onebit" and not lead["losses"][-1] < \
                lead["losses"][GX_FREEZE_STEP - 1]:
            problems.append("onebit: the loss did not fall after the "
                            "freeze step")
    fp32 = r0["deferred_fp32"]["vs_stage0_fp32"]
    if not (fp32["first_step_update_rel_l2"] <= GX_FP32_UPDATE_REL_L2
            and fp32["grad_norm_rel_err_by_step"][0]
            <= ZERO_GRAD_NORM_FIRST_REL_TOL
            and fp32["loss_rel_err"] <= ZERO_LOSS_REL_TOL
            and fp32["update_rel_l2"] <= ZERO_UPDATE_REL_L2):
        problems.append(f"(a) at f32 against the stage-0 f32 exchange: "
                        f"{fp32}")
    control = r0.get("control")
    if world > 1 and control["loss_rel_err"] <= GX_LOSS_REL_TOL:
        problems.append(f"the control does not break the bound: {control}")
    return problems, r0["deferred_bf16"]["launches"]


def zero_small_engine(stage, dtype, config_over, seed=5, gas=1):
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT, GPTConfig

    cfg = GPTConfig(vocab_size=512, n_positions=128, n_embd=256, n_layer=2,
                    n_head=4, dtype=dtype, use_flash_attention=True)
    config = {"train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": gas, "gradient_clipping": 1.0,
              "optimizer": {"type": "FusedAdam",
                            "params": {"lr": SMALL_LR, "weight_decay": 0.1}},
              "steps_per_print": 10 ** 9, "tpu": {"use_pallas_optimizer": True},
              "zero_optimization": {"stage": stage},
              "comms_logger": {"enabled": True}}
    config.update(config_over)
    if dtype == torch.bfloat16:
        config["bf16"] = {"enabled": True}
    return deepspeed_tpu_torch.initialize(model=GPT(cfg), config=config,
                                          seed=seed)[0]


def zero_small_batches(world, n, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [{"input_ids": x, "labels": x}
            for x in rng.randint(0, 512, size=(n, 2 * world, 128))]


def zero_small_runs(world, rank):
    """The paths the 1.3B runs do not reach, on small GPTs: stages 2 and 3
    at gas 2 (micro and apply graphs holding collectives; at stage 3 the
    gathers and reduce-scatters too), fp16 at stage 1 from a growing loss
    scale (the first overflow is local to the shard that holds the largest
    gradient; every rank must skip it), and a stage-1 tag saved at this
    world and loaded at this world and stages 2 and 3."""
    import torch

    from deepspeed_tpu_torch import comm

    out = {}
    # stages 2 and 3, gas 2: captured against eager
    batches = zero_small_batches(world, 2, seed=6)
    want = {"flash_attention_fwd": 2 * 2 * 8, "flash_attention_bwd_dq": 32,
            "flash_attention_bwd_dkv": 32, "fused_adamw": 8,
            "block_sparse_fwd": 0, "block_sparse_dq": 0, "block_sparse_dkv": 0,
            **UNSEGMENTED}
    for stage in (2, 3):
        check, launches, losses, _, _, e_losses, _ = captured_against_eager(
            lambda: zero_small_engine(stage, torch.bfloat16, {}, gas=2),
            batches, 8)
        out[f"stage{stage}_gas2"] = {
            "captured_vs_eager": check, "launches": launches,
            "launches_ok": launches == want, "losses": losses,
            "eager_losses": e_losses}
    # fp16 at stage 1 on a new batch each step (a repeated one is learnt,
    # and its gradients shrink): the scale doubles after every clean step
    # (window 1) from 2^12 until it overflows, halves, and climbs again
    history = []

    def make_fp16():
        eng = zero_small_engine(1, torch.float16, {"fp16": {
            "enabled": True, "initial_scale_power": 12,
            "loss_scale_window": 1, "hysteresis": 1}})
        history.append([])
        real = eng._train_batch

        def logged(it, eager=False):
            loss = real(it, eager=eager)
            history[-1].append([eng.loss_scale, eng.skipped_steps,
                                eng.optimizer.count,
                                bool(eng.optimizer.local_overflow)])
            return loss
        eng._train_batch = logged
        return eng

    check, _, losses, _, _, _, _ = captured_against_eager(
        make_fp16, zero_small_batches(world, SMALL_CAPTURE_STEPS, seed=7),
        SMALL_CAPTURE_STEPS)
    out["fp16_stage1"] = {"captured_vs_eager": check,
                          "scale_skipped_count_local_by_step": history[0],
                          "eager_by_step": history[1],
                          "same_as_eager": history[0] == history[1],
                          "losses": losses}
    # a stage-1 tag at this world, resumed at this world (stages 1 and 2)
    ckpt_dir = os.path.join(ZERO_DIR, "small_ckpt")
    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    comm.barrier()
    batches = zero_small_batches(world, 4, seed=8)
    eng = zero_small_engine(1, torch.float32, {}, seed=9)
    start = {k: v.clone() for k, v in eng.params.items()}
    run = []
    for i, b in enumerate(batches):
        run.append(float(eng.train_batch(iter([b]))))
        if i == 1:
            eng.save_checkpoint(ckpt_dir)
            saved = {k: v.clone() for k, v in eng.params.items()}
    final = {k: v.clone() for k, v in eng.params.items()}
    del eng
    resumed = {}
    for stage in (1, 2, 3):
        eng = zero_small_engine(stage, torch.float32, {}, seed=11)
        eng.load_checkpoint(ckpt_dir)
        losses = [float(eng.train_batch(iter([b]))) for b in batches[2:]]
        got = eng.params
        resumed[stage] = {
            "losses": losses, "reshard": eng.last_reshard.mismatches,
            "bit_identical": losses == run[2:] and all(
                torch.equal(got[k], v) for k, v in final.items()),
            "loss_rel_err": max(abs(a - b) / abs(b)
                                for a, b in zip(losses, run[2:])),
            "update_rel_l2": update_rel_l2(got, final, saved)}
        del eng
    out["checkpoint"] = {"dir": ckpt_dir, "losses": run, "resumed": resumed}
    if rank == 0:
        torch.save({"start": start, "saved": saved, "final": final,
                    "losses": run, "batches": batches},
                   os.path.join(ZERO_DIR, "small_ckpt_run.pt"))
    free_cuda()
    return out


ZERO_DATA_STEPS, ZERO_DATA_SAVE = 4, 2
ZERO_DATA_DIR = os.path.join(ZERO_DIR, "data_ckpt")
ZERO_DATA_SEQ = 256


def zero_data_corpus():
    return data_corpus(512, n=600, seed=3, lo=8, hi=ZERO_DATA_SEQ,
                       long_docs=(300,))


def zero_data_engine(shard, seed=5):
    """A small bf16 GPT at ZeRO stage 1 on the packed pipeline (prefetch
    on, ``shard`` as given), micro 2 x 256 per rank."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT, GPTConfig

    cfg = GPTConfig(vocab_size=512, n_positions=ZERO_DATA_SEQ, n_embd=256,
                    n_layer=2, n_head=4, dtype=torch.bfloat16,
                    use_flash_attention=True)
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
              "bf16": {"enabled": True},
              "optimizer": {"type": "FusedAdam", "params": {"lr": SMALL_LR}},
              "tpu": {"use_pallas_optimizer": True},
              "zero_optimization": {"stage": 1}, "steps_per_print": 10 ** 9,
              "data_pipeline": dict(DATA_PIPELINE, seq_length=ZERO_DATA_SEQ,
                                    shard=shard)}
    return deepspeed_tpu_torch.initialize(model=GPT(cfg), config=config,
                                          seed=seed,
                                          training_data=zero_data_corpus())


def zero_data_run(shard, steps, save=False, load=False):
    """``steps`` steps of ``zero_data_engine(shard)``: the batches this rank
    drew (token and segment ids) and the losses; ``save``: a tag under
    ``ZERO_DATA_DIR`` after ``ZERO_DATA_SAVE`` steps; ``load``: that tag
    first."""
    engine, _, loader, _ = zero_data_engine(shard)
    out = {}
    if load:
        engine.load_checkpoint(ZERO_DATA_DIR)
        out["stream"] = loader.state_dict()["stream"]
    tap = BatchTap(iter(loader))
    losses = []
    for i in range(steps):
        losses.append(float(engine.train_batch(tap)))
        if save and i + 1 == ZERO_DATA_SAVE:
            engine.save_checkpoint(ZERO_DATA_DIR)
            out["saved_stream"] = loader.state_dict()["stream"]
    engine.destroy()
    out.update(losses=losses, ids=[x.tolist() for x in tap.ids],
               segment_ids=[x.tolist() for x in tap.segment_ids])
    del engine, loader, tap
    free_cuda()
    return out


def zero_data_runs():
    """The data path on this rank: ``shard: "process"`` with a tag saved
    after 2 of 4 steps, ``shard: "none"``, and the tag resumed at this
    world."""
    return {"process": zero_data_run("process", ZERO_DATA_STEPS, save=True),
            "none": zero_data_run("none", ZERO_DATA_STEPS - 1),
            "resumed": zero_data_run("process",
                                     ZERO_DATA_STEPS - ZERO_DATA_SAVE,
                                     load=True)}


def zero_data_one_card():
    """The data tag in a group-less engine on card 0: the stream's state
    after the load, and one step."""
    engine, _, loader, _ = zero_data_engine("process", seed=6)
    engine.load_checkpoint(ZERO_DATA_DIR)
    out = {"stream": loader.state_dict()["stream"],
           "loss": float(engine.train_batch(iter(loader))),
           "reshard": engine.last_reshard.mismatches}
    engine.destroy()
    del engine, loader
    free_cuda()
    return out


def _documents(ids, segment_ids):
    """The documents of a packed batch, as tuples of tokens."""
    import numpy as np

    ids, seg = np.asarray(ids), np.asarray(segment_ids)
    return [tuple(row[s_row == s].tolist()) for row, s_row in zip(ids, seg)
            for s in range(1, int(s_row.max()) + 1)]


def zero_data_report(world, results, one_card, smi):
    """The data part's line; returns the failed checks. ``shard:
    "process"``: the ranks' documents are disjoint, each rank's the prefix
    of its own stride; ``"none"``: each rank's rows are its slice of the
    world-1 pipeline's batch; the tag resumed at this world gives every
    rank its own next batches and losses; on one card the stream
    re-strides from rank 0's state (at world > 1)."""
    import numpy as np

    from deepspeed_tpu_torch.data import PackedDataPipeline, ShardedSampleStream

    runs = [r["data"] for r in results]
    corpus = zero_data_corpus()
    problems = []
    drawn = [[d for ids, seg in zip(r["process"]["ids"],
                                    r["process"]["segment_ids"])
              for d in _documents(ids, seg)] for r in runs]
    seen = [d for docs in drawn for d in docs]
    disjoint = len(seen) == len(set(seen))
    prefix = []
    for rank, docs in enumerate(drawn):
        stream = ShardedSampleStream(corpus, seed=DATA_PIPELINE["seed"],
                                     shard_rank=rank, num_shards=world)
        own = [tuple(next(stream)[:ZERO_DATA_SEQ].tolist()) for _ in docs]
        prefix.append(sorted(own) == sorted(docs))
    ref = PackedDataPipeline(corpus, batch_size=2 * world,
                             seq_length=ZERO_DATA_SEQ,
                             seed=DATA_PIPELINE["seed"])
    none_ok = True
    for step in range(ZERO_DATA_STEPS - 1):
        want = next(ref)
        for rank, r in enumerate(runs):
            rows = slice(2 * rank, 2 * rank + 2)
            none_ok &= (np.array_equal(r["none"]["ids"][step],
                                       want["input_ids"][rows])
                        and np.array_equal(r["none"]["segment_ids"][step],
                                           want["segment_ids"][rows]))
    resumed = [r["resumed"]["ids"] == r["process"]["ids"][ZERO_DATA_SAVE:]
               and r["resumed"]["losses"]
               == r["process"]["losses"][ZERO_DATA_SAVE:]
               and r["resumed"]["stream"] == r["process"]["saved_stream"]
               for r in runs]
    saved0 = runs[0]["process"]["saved_stream"]
    if world > 1:
        want_stream = dict(saved0, num_shards=1, cursor=0, epoch_offset=(
            saved0["epoch_offset"] + saved0["cursor"] * world))
    else:
        want_stream = saved0
    line = {"phase": "zero", "world": world, "card": smi, "data": {
        "shard_process": {"documents_by_rank": [len(d) for d in drawn],
                          "disjoint": disjoint,
                          "prefix_of_own_stride_by_rank": prefix,
                          "losses_by_rank": [r["process"]["losses"]
                                             for r in runs],
                          "saved_cursor_by_rank": [
                              r["process"]["saved_stream"]["cursor"]
                              for r in runs]},
        "shard_none_rows_are_world1_slices": none_ok,
        "resumed_same_world_identical_by_rank": resumed,
        "one_card": dict(one_card, want_stream=want_stream)}}
    emit(line)
    if not (disjoint and all(prefix)):
        problems.append(f"data: shard process {line['data']['shard_process']}")
    if any(r["process"]["losses"] != runs[0]["process"]["losses"]
           for r in runs):
        problems.append("data: the ranks' losses differ")
    if not none_ok:
        problems.append("data: shard none rows are not the world-1 slices")
    if not all(resumed):
        problems.append(f"data: resume at world {world}: {resumed}")
    if one_card["stream"] != want_stream or not math.isfinite(
            one_card["loss"]):
        problems.append(f"data: one-card resume {one_card}, want stream "
                        f"{want_stream}")
    return problems


def zero_rank(rank, world, url):
    """One rank of the zero phase (the whole phase at world 1, in process).
    Rank 0 first runs the group-less reference on its card, then every rank
    joins the NCCL group and runs the four stages at 1.3B, the 6.7B pair at
    world >= 4, and the small paths.
    Returns this rank's results; the process group is destroyed at the
    end."""
    from datetime import timedelta

    import numpy as np
    import torch

    from deepspeed_tpu_torch import comm

    torch.cuda.set_device(rank)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 50257, size=(4 * world, 1024)).astype(np.int64)
    batch = {"input_ids": ids, "labels": ids}
    t0 = time.perf_counter()
    ref = zero_reference(world, batch) if rank == 0 else None
    # the control: at world > 1, the step of a run that lost the last
    # rank's rows must break at least one of the bounds the run is held to
    control = (zero_reference(world - 1, batch) if rank == 0 and world > 1
               else None)
    bert_batch = mlm_batch(world * bert_zero_gas(world), SPARSE_SEQ, seed=3)
    bert_ref = zero_bert_reference(bert_batch) if rank == 0 else None
    bert_witness = None
    if rank == 0:
        # the group-less engine against itself, the micro batches summed
        # in the reverse order: how far rounding alone moves a BERT run
        other = zero_bert_reference(bert_batch, reverse=True)
        bert_witness = {
            "update": bert_update_split(other["final"], bert_ref["final"],
                                        bert_ref["start"]),
            "first_step_update_rel_l2": update_rel_l2(
                {k: v.to("cuda") for k, v in other["first"].items()},
                bert_ref["first"], bert_ref["start"]),
            "loss_rel_err": max(rel_errs(other["losses"],
                                         bert_ref["losses"])),
            "grad_norm_rel_err_by_step": rel_errs(other["grad_norms"],
                                                  bert_ref["grad_norms"])}
        del other
    ref_s = time.perf_counter() - t0
    comm.init_distributed(init_method=url, rank=rank, world_size=world,
                          local_rank=rank,
                          timeout=timedelta(seconds=ZERO_GROUP_TIMEOUT_S))
    out = {"rank": rank, "world": world, "reference_s": ref_s,
           "device": torch.cuda.get_device_name(rank)}
    if ref is not None:
        out["reference"] = {"losses": ref["losses"],
                            "grad_norms": ref["grad_norms"],
                            "step_ms": ref["step_ms"]}
        out["bert_reference"] = {k: bert_ref[k] for k in (
            "losses", "grad_norms", "step_ms")}
        out["bert_witness"] = bert_witness
    out["yardstick"] = zero_yardstick(world)
    out["stages"] = {}
    zero_launches = {}
    for stage in ZERO_STAGES:
        run = zero_stage_run(stage, world, batch, ref, control)
        out["stages"][stage] = run
        if stage < 3:
            for name, n in run["launches"].items():
                zero_launches[name] = zero_launches.get(name, 0) + n
    # the stage-0-2 path (its runs' launches added) and the stage-3 path
    out["launches"] = zero_launches
    out["launches_stage3"] = out["stages"][3]["launches"]
    out["grad_exchange"] = gx_runs(world, rank, batch, ref, control)
    if world >= SIXB_MIN_WORLD:
        out["gpt2_6p7b"] = zero_6p7b_pair(world, rank)
    t1 = time.perf_counter()
    out["bert_stage3"] = zero_bert_stage3(world, bert_batch, bert_ref)
    del bert_ref
    if world >= SIXB_MIN_WORLD:
        out["bert_exchanges"] = zero_bert_exchanges(world, bert_batch)
    out["bert_seconds"] = time.perf_counter() - t1
    if rank == 0:
        n = -(-GPT_1P3B_PARAMS // (world * 64)) * 64  # a shard, as padded
        out["b4_shard"] = time_b4_shard(n)
    out["small"] = zero_small_runs(world, rank)
    out["data"] = zero_data_runs()
    comm.barrier()
    comm.destroy_distributed()
    return out


def zero_rank_main(argv):
    """``chip_smoke.py --zero-rank RANK WORLD URL OUT``: one rank's process
    at world > 1; its results go to OUT as JSON."""
    rank, world, url, out = argv
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    result = zero_rank(int(rank), int(world), url)
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


def zero_one_card_resume(world):
    """The small stage-1 tag saved at ``world`` in a group-less engine on
    card 0: its 2 resumed steps against the saving run's."""
    import torch

    saved = torch.load(os.path.join(ZERO_DIR, "small_ckpt_run.pt"),
                       weights_only=False)
    eng = zero_small_engine(1, torch.float32,
                            {"train_micro_batch_size_per_gpu": 2 * world},
                            seed=11)
    eng.load_checkpoint(os.path.join(ZERO_DIR, "small_ckpt"))
    losses = [float(eng.train_batch(iter([b]))) for b in saved["batches"][2:]]
    got = dict(eng.module.state_dict())
    out = {"losses": losses, "reshard": eng.last_reshard.mismatches,
           "loss_rel_err": max(abs(a - b) / abs(b)
                               for a, b in zip(losses, saved["losses"][2:])),
           "update_rel_l2": update_rel_l2(got, saved["final"],
                                          saved["saved"])}
    del eng
    free_cuda()
    return out


def zero_spawn(world):
    """One process per card (``--zero-rank``), started together, a file
    rendezvous under build/; every process is waited for or killed."""
    rdv = os.path.join(os.path.abspath(ZERO_DIR), "rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    procs, outs, logs = [], [], []
    for r in range(world):
        outs.append(os.path.join(ZERO_DIR, f"rank{r}.json"))
        logs.append(open(os.path.join(ZERO_DIR, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--zero-rank", str(r),
             str(world), f"file://{rdv}", outs[-1]],
            stdout=logs[-1], stderr=subprocess.STDOUT,
            env=dict(os.environ, LOCAL_RANK=str(r))))
    deadline = time.monotonic() + ZERO_RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        for r in failed:
            with open(os.path.join(ZERO_DIR, f"rank{r}.log")) as f:
                print(f"--- zero rank {r} log (tail) ---\n{f.read()[-3000:]}",
                      flush=True)
        raise AssertionError(f"zero: ranks {failed} failed")
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def phase_zero():
    """Data parallelism and ZeRO 0-3 over NCCL at world = the visible
    cards: in process on a one-rank group at world 1, one process per card
    above. Returns rank 0's kernel launches by path: ``zero``, the 1.3B
    runs at stages 0-2 added, and ``zero_stage3`` (counts set to 0 before
    each run's captured steps)."""
    import torch

    world = torch.cuda.device_count()
    os.makedirs(ZERO_DIR, exist_ok=True)
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    topo_text = (topo.stdout + topo.stderr).strip()
    print(topo_text, flush=True)
    emit({"phase": "zero", "world": world, "nvidia_smi_topo": topo_text,
          "nvidia_smi_topo_rc": topo.returncode})
    free_cuda()
    t0 = time.perf_counter()
    if world == 1:
        results = [zero_rank(0, 1, None)]
    else:
        results = zero_spawn(world)
    one_card = zero_one_card_resume(world)
    data_one_card = zero_data_one_card()
    seconds = time.perf_counter() - t0
    return zero_report(world, results, one_card, data_one_card, seconds)


def within_zero_bounds(vs):
    """Whether a 1.3B run's losses, updates and grad norms lie within the
    bounds against another run's."""
    return (vs["loss_rel_err"] <= ZERO_LOSS_REL_TOL
            and vs["update_rel_l2"] <= ZERO_UPDATE_REL_L2
            and vs["grad_norm_rel_err_by_step"][0]
            <= ZERO_GRAD_NORM_FIRST_REL_TOL
            and vs["grad_norm_rel_err"] <= ZERO_GRAD_NORM_REL_TOL)


def zero_report(world, results, one_card, data_one_card, seconds):
    """One JSON line per stage and one for the small paths, the world on
    each; raises on any failed check."""
    r0 = results[0]
    problems = []
    smi = nvidia_smi_line()
    for stage in ZERO_STAGES:
        runs = [r["stages"][str(stage)] if str(stage) in r["stages"]
                else r["stages"][stage] for r in results]
        lead = runs[0]
        vs = lead["vs_group_less"]
        yard = r0["yardstick"]
        line = {"phase": "zero", "world": world, "stage": stage,
                "card": smi, "model": "gpt2-1.3b", "batch_per_rank": [4, 1024],
                "steps": STEPS, "losses": lead["losses"],
                "group_less_losses": r0["reference"]["losses"],
                "vs_group_less": vs,
                "vs_control": lead.get("vs_control"),
                "tolerance": {"loss_rel": ZERO_LOSS_REL_TOL,
                              "update_rel_l2": ZERO_UPDATE_REL_L2,
                              "grad_norm_rel_first_step":
                                  ZERO_GRAD_NORM_FIRST_REL_TOL,
                              "grad_norm_rel": ZERO_GRAD_NORM_REL_TOL},
                "step_ms_median_by_rank": [r["step_ms_median"] for r in runs],
                "eager_step_ms_median_by_rank": [r["eager_step_ms_median"]
                                                 for r in runs],
                "group_less_step_ms_median": statistics.median(
                    r0["reference"]["step_ms"][CAPTURE_WARMUP + 1:]),
                "peak_allocated_gb_by_rank": [r["peak_allocated_gb"]
                                              for r in runs],
                "predicted_state_gb": lead["predicted_state_gb"],
                "captured_vs_eager_by_rank": [r["captured_vs_eager"]["identical"]
                                              for r in runs],
                "launches_rank0": lead["launches"],
                "graph_comms_per_replay": lead["graph_comms_per_replay"],
                "comms_counters_rank0": lead["comms_counters"],
                "traced_replay_by_rank": [r["traced_replay"] for r in runs],
                "yardstick_all_reduce": yard}
        if stage == 1:
            # the prediction of PERF.md: the one-card step, less 3/4 of B4,
            # plus a reduce-scatter and an all-gather of the bf16 gradient
            # at the yardstick's bus bandwidth
            bw = yard["bus_gb_per_s"]
            xfer = (2 * (world - 1) / world * ZERO_YARDSTICK_BYTES / bw / 1e6
                    if bw else 0.0)
            line["predicted_step_ms"] = (ONE_CARD_STEP_MS
                                         - (1 - 1 / world) * B4_MS + xfer)
        emit(line)
        if not all(r["captured_vs_eager"]["identical"] for r in runs):
            problems.append(f"stage {stage}: captured and eager steps differ")
        if any(r["losses"] != lead["losses"] for r in runs):
            problems.append(f"stage {stage}: ranks returned other losses")
        if any(r["checksums"] != lead["checksums"] for r in runs):
            problems.append(f"stage {stage}: ranks hold other parameters")
        for r in runs:
            for name, per in PER_STEP.items():
                if r["launches"][name] != per * STEPS:
                    problems.append(f"stage {stage}: {name} launched "
                                    f"{r['launches'][name]}, want "
                                    f"{per} x {STEPS}")
        if not lead["losses"][-1] <= lead["losses"][0] - TRAIN_MIN_LOSS_DROP:
            problems.append(f"stage {stage}: the loss did not fall")
        if not within_zero_bounds(vs):
            problems.append(f"stage {stage}: against the group-less engine "
                            f"{vs}")
        if world > 1 and within_zero_bounds(lead["vs_control"]):
            problems.append(f"stage {stage}: the bounds do not tell the run "
                            f"from one that dropped a rank's rows "
                            f"{lead['vs_control']}")
    peaks = {stage: max(r["stages"][str(stage)]["peak_allocated_gb"]
                        if str(stage) in r["stages"] else
                        r["stages"][stage]["peak_allocated_gb"]
                        for r in results) for stage in ZERO_STAGES}
    if world >= SIXB_MIN_WORLD and not peaks[3] < peaks[1]:
        problems.append(f"stage 3's peak per rank {peaks[3]} GB is not "
                        f"below stage 1's {peaks[1]}")
    problems += zero_6p7b_report(world, results, smi)
    bert_problems, bert_launches = zero_bert_report(world, results, smi)
    problems += bert_problems
    gx_problems, gx_launches = gx_report(world, results, smi)
    problems += gx_problems
    b4 = r0["b4_shard"]
    if not (all(b4["bit_identical"].values()) and b4["skip_flag_leaves_all_unchanged"]
            and b4["p_moved_share"] >= ADAMW_MIN_MOVED):
        problems.append(f"B4 over the shard against its plain version: {b4}")
    small = [r["small"] for r in results]
    line = {"phase": "zero", "world": world, "small": small[0],
            "one_card_resume": one_card, "seconds": seconds,
            "bert_seconds_by_rank": [r["bert_seconds"] for r in results],
            "reference_seconds_rank0": r0["reference_s"],
            "b4_shard": b4,
            "fp16_local_overflow_by_rank": [
                [s[3] for s in r["fp16_stage1"]
                 ["scale_skipped_count_local_by_step"]] for r in small]}
    emit(line)
    for r in small:
        for stage in (2, 3):
            run = r[f"stage{stage}_gas2"]
            if not (run["captured_vs_eager"]["identical"]
                    and run["launches_ok"]):
                problems.append(f"small stage {stage} gas 2: captured and "
                                "eager differ or launches are off")
        if not (r["fp16_stage1"]["captured_vs_eager"]["identical"]
                and r["fp16_stage1"]["same_as_eager"]):
            problems.append("small fp16 stage 1: captured and eager differ")
        ck = {int(k): v for k, v in r["checkpoint"]["resumed"].items()}
        if not ck[1]["bit_identical"] or ck[1]["reshard"]:
            problems.append("small checkpoint: the same world and stage did "
                            "not resume bit for bit")
        for stage in (2, 3):
            got = ck[stage]
            if not (got["loss_rel_err"] <= ZERO_SMALL_LOSS_REL_TOL
                    and got["update_rel_l2"] <= ZERO_SMALL_UPDATE_REL_L2
                    and got["reshard"] == [f"zero_stage 1 -> {stage}"]):
                problems.append(f"small checkpoint at stage {stage}: {got}")
    # every rank saw the same skips and scales; a skip happened, on every
    # rank, exactly where some rank's own shard overflowed
    hist = [r["fp16_stage1"]["scale_skipped_count_local_by_step"]
            for r in small]
    if any([h[:3] for h in rank] != [h[:3] for h in hist[0]]
           for rank in hist):
        problems.append("fp16: the ranks' scales, skips or counts differ")
    prev = 0
    local_only = 0
    for i, step in enumerate(hist[0]):
        skipped = step[1] > prev
        prev = step[1]
        flags = [rank[i][3] for rank in hist]
        if skipped != any(flags):
            problems.append(f"fp16 step {i}: skipped={skipped}, local "
                            f"overflow flags {flags}")
        local_only += skipped and not all(flags)
    if not hist[0][-1][1]:
        problems.append("fp16: no step overflowed")
    if world > 1 and not local_only:
        problems.append("fp16: no overflow was local to some ranks' shards")
    expect_reshard = ([f"world_size {world} -> 1", f"fsdp {world} -> 1"]
                      if world > 1 else [])
    if not (one_card["loss_rel_err"] <= ZERO_SMALL_LOSS_REL_TOL
            and one_card["update_rel_l2"] <= ZERO_SMALL_UPDATE_REL_L2
            and one_card["reshard"] == expect_reshard):
        problems.append(f"small checkpoint on one card: {one_card}")
    problems += zero_data_report(world, results, data_one_card, smi)
    shutil.rmtree(ZERO_DIR, ignore_errors=True)
    if problems:
        raise AssertionError(f"zero (world {world}): {problems}")
    return {"zero": r0["launches"], "zero_stage3": r0["launches_stage3"],
            "grad_exchange": gx_launches, "zero_bert_stage3": bert_launches}


def zero_6p7b_report(world, results, smi):
    """The 6.7B pair's line (one line saying why none ran below
    ``SIXB_MIN_WORLD`` cards); returns the failed checks."""
    if world < SIXB_MIN_WORLD:
        emit({"phase": "zero", "world": world, "model": "gpt2-6.7b",
              "ran": False, "why": f"its state (12N = 80 GB at 6.65e9 "
              f"parameters) does not fit on {world} card(s); the pair runs "
              f"on {SIXB_MIN_WORLD} or more"})
        return []
    runs = [{int(k): v for k, v in r["gpt2_6p7b"].items()} for r in results]
    lead = runs[0]
    problems = []
    for stage in (2, 3):
        by_rank = [r[stage] for r in runs]
        line = {"phase": "zero", "world": world, "model": "gpt2-6.7b",
                "stage": stage, "card": smi,
                "batch_per_rank": [SIXB_MICRO, 1024], "steps": STEPS,
                "losses": lead[stage]["losses"],
                "step_ms_median_by_rank": [r["step_ms_median"]
                                           for r in by_rank],
                "peak_allocated_gb_by_rank": [r["peak_allocated_gb"]
                                              for r in by_rank],
                "predicted_state_gb": lead[stage]["predicted_state_gb"],
                "launches_rank0": lead[stage]["launches"],
                "graph_comms_per_replay":
                    lead[stage]["graph_comms_per_replay"],
                "traced_replay_by_rank": [r["traced_replay"]
                                          for r in by_rank]}
        if stage == 3:
            line.update({
                "eager_step_ms_median_by_rank": [
                    r["eager_step_ms_median"] for r in by_rank],
                "captured_vs_eager_by_rank": [
                    r["captured_vs_eager"]["identical"] for r in by_rank],
                "vs_stage2": {
                    "loss_rel_err": lead[3]["loss_rel_err_vs_stage2"],
                    "update_rel_l2": lead[3]["update_rel_l2_vs_stage2"],
                    "grad_norm_rel_err_by_step":
                        lead[3]["grad_norm_rel_err_vs_stage2_by_step"]},
                "tolerance": {"loss_rel": ZERO_LOSS_REL_TOL,
                              "update_rel_l2": ZERO_UPDATE_REL_L2}})
        emit(line)
        for r in by_rank:
            for name, per in SIXB_PER_STEP.items():
                if r["launches"][name] != per * STEPS:
                    problems.append(f"6.7B stage {stage}: {name} launched "
                                    f"{r['launches'][name]}, want {per} x "
                                    f"{STEPS}")
        if any(r["losses"] != lead[stage]["losses"] for r in by_rank):
            problems.append(f"6.7B stage {stage}: ranks returned other "
                            "losses")
        if any(r["checksums"] != lead[stage]["checksums"] for r in by_rank):
            problems.append(f"6.7B stage {stage}: ranks hold other "
                            "parameters")
        if not all(math.isfinite(x) for x in lead[stage]["losses"]):
            problems.append(f"6.7B stage {stage}: a loss is not finite")
    three = lead[3]
    if not all(r[3]["captured_vs_eager"]["identical"] for r in runs):
        problems.append("6.7B stage 3: captured and eager steps differ")
    if not (three["loss_rel_err_vs_stage2"] <= ZERO_LOSS_REL_TOL
            and three["update_rel_l2_vs_stage2"] <= ZERO_UPDATE_REL_L2):
        problems.append(f"6.7B: stage 3 against stage 2: loss "
                        f"{three['loss_rel_err_vs_stage2']}, update "
                        f"{three['update_rel_l2_vs_stage2']}")
    if not (max(r[3]["peak_allocated_gb"] for r in runs)
            < min(r[2]["peak_allocated_gb"] for r in runs)):
        problems.append("6.7B: stage 3's peak is not below stage 2's")
    return problems


# ---------------------------------------------------------------------------
# --against DIR: the backward kernels and B4 of this tree against another build
# ---------------------------------------------------------------------------
def _other_build(root):
    """The other checkout's ``ops/cuda/build.py``, loaded from its own file:
    it builds that checkout's sources into that checkout's ``build/``."""
    import importlib.util
    from pathlib import Path

    path = Path(root) / "deepspeed_tpu_torch" / "ops" / "cuda" / "build.py"
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build_both(other):
    """Builds both trees' libraries at once; raises if either fails.
    Returns ptxas's registers and spill bytes of each build's backward
    wgmma kernels."""
    import threading

    from deepspeed_tpu_torch.ops.cuda import build

    errors, logs = [], {}

    def run(who, mod):
        try:
            logs[who] = mod.build()
        except Exception as e:  # reported after both builds ended
            errors.append(e)

    threads = [threading.Thread(target=run, args=w)
               for w in (("this", build), ("other", other))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return {who: {name: info for lib in ("flash_attention_bwd", "block_sparse_attention")
                  if lib in built
                  for name, info in ptxas_by_kernel(built[lib]["log"]).items()
                  if "dq_wgmma" in name or "dkv_wgmma" in name}
            for who, built in logs.items()}


def _twin(other, lib_name, fn):
    """``fn`` of the other build's library ``lib_name``, with this tree's
    argument types. A trailing argument that the other build does not
    declare (the block-sparse order pointer) is left unread by it."""
    import ctypes

    lib = ctypes.CDLL(str(other.library_path(lib_name)))
    twin = getattr(lib, fn.__name__)
    twin.argtypes, twin.restype = fn.argtypes, fn.restype
    return twin


def _in_turns(run_other, run_this):
    """Device ms of both, other, this, this, other."""
    times = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        times[who].append(device_ms(run_other if who == "other" else run_this)["ms"])
    return times, statistics.mean(times["this"]) / statistics.mean(times["other"])


def ab_flash(other):
    """B2 and B3 of both builds at GPT-2 1.3B's training shape, causal, and
    at [2, 1024, 16, 64] under packed segments, bf16: outputs must be
    bit-identical."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    dq_fn, dkv_fn = fa._bwd_kernels()
    pairs = {"flash_dq": (_twin(other, "flash_attention_bwd", dq_fn), dq_fn, 1),
             "flash_dkv": (_twin(other, "flash_attention_bwd", dkv_fn), dkv_fn, 2)}
    gen = torch.Generator().manual_seed(30)
    ok = True
    for b, t, h, d, packed in ((4, 1024, 16, 128, False), (2, 1024, 16, 64, True)):
        qkv = torch.randn((b, t, 3 * h * d), generator=gen).to("cuda", torch.bfloat16)
        q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
        seg = _segments(b, t, gen, "cuda") if packed else None
        do = torch.randn((b, t, h, d), generator=gen).to("cuda", torch.bfloat16)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)
        delta = fa.bwd_delta(o, do)
        for name, (fn_other, fn_this, n_out) in pairs.items():
            outs = {w: [torch.empty_like(q) for _ in range(n_out)] for w in ("other", "this")}

            def call(fn, who):
                err = fa._bwd_call(fn, q, k, v, lse, delta, do, seg, True, d ** -0.5,
                                   outs[who])
                if err:
                    raise RuntimeError(f"{name} ({who}) failed: CUDA error {err}")

            call(fn_other, "other")
            call(fn_this, "this")
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(outs["other"], outs["this"]))
            times, ratio = _in_turns(lambda: call(fn_other, "other"),
                                     lambda: call(fn_this, "this"))
            ok = ok and same
            emit({"phase": "against", "kernel": name, "shape": [b, t, h, d],
                  "causal": True, "segments": packed, "bit_identical": same,
                  "other_ms": times["other"], "this_ms": times["this"],
                  "this_over_other": ratio})
    return ok


def ab_sparse(other):
    """B6 and B7 of both builds at BERT-Large's BigBird shape, block 128,
    bf16, each against the plain backward (GRAD_REL_TOL)."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa

    dq_fn, dkv_fn = bsa._kernels()[1:3]
    b, t, h, d, block = 1, 4096, 16, 64, 128
    layout = _sparse_config("BigBirdSparsityConfig", h, block, num_random_blocks=1,
                            num_sliding_window_blocks=3,
                            num_global_blocks=1).make_layout(t)
    tables = bsa.build_index_tables(layout, "cuda")
    gen = torch.Generator().manual_seed(31)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen).to("cuda", torch.bfloat16)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    do = torch.randn((b, t, h, d), generator=gen).to("cuda", torch.bfloat16)
    o, lse = bsa.block_sparse_fwd(q, k, v, tables, block=block)
    want = dict(zip(("dq", "dk", "dv"), bsa.block_sparse_attention_backward_reference(
        q, k, v, o, lse, do, layout, block=block)))
    delta = bsa.bwd_delta(o, do)
    ok = True
    for name, fn_this, rows, grads in (
            ("sparse_dq", dq_fn, bsa._rows(tables), ("dq",)),
            ("sparse_dkv", dkv_fn, bsa._columns(tables), ("dk", "dv"))):
        fn_other = _twin(other, "block_sparse_attention", fn_this)
        outs = {w: [torch.empty_like(q) for _ in grads] for w in ("other", "this")}

        def call(fn, who):
            err = bsa._call(fn, q, k, v, rows, block, False, d ** -0.5, do.data_ptr(),
                            lse.data_ptr(), delta.data_ptr(),
                            *(x.data_ptr() for x in outs[who]))
            if err:
                raise RuntimeError(f"{name} ({who}) failed: CUDA error {err}")

        call(fn_other, "other")
        call(fn_this, "this")
        torch.cuda.synchronize()
        errs = {who: {g: _rel_err(x, want[g]) for g, x in zip(grads, outs[who])}
                for who in outs}
        times, ratio = _in_turns(lambda: call(fn_other, "other"),
                                 lambda: call(fn_this, "this"))
        ok = ok and all(e <= GRAD_REL_TOL["bfloat16"]
                        for per in errs.values() for e in per.values())
        emit({"phase": "against", "kernel": name, "shape": [b, t, h, d], "block": block,
              "this_variant": bsa.kernel_variant(q.dtype, block), "grad_rel_err": errs,
              "other_ms": times["other"], "this_ms": times["this"],
              "this_over_other": ratio})
    return ok


def ab_adamw(other, root):
    """B4 of both builds over GPT-2 1.3B's parameter shapes (bf16 p and g,
    f32 m and v), lr 2e-4 at step 4: one call each on copies of the same
    tensors must give bit-identical p, m and v, then both are timed in
    turns. This tree's kernel reads lr, c1, c2 and the skip flag from a
    device buffer; a build whose source predates that takes them as host
    floats (told apart by its ``csrc/fused_adamw.cu``)."""
    import ctypes
    from pathlib import Path

    import torch

    from deepspeed_tpu_torch.models.transformer_lm import GPT, gpt2_config
    from deepspeed_tpu_torch.ops.cuda import fused_adam as fadam

    this = fadam._kernel()
    twin = ctypes.CDLL(str(other.library_path("fused_adamw"))).ds_fused_adamw
    src = (Path(root) / "deepspeed_tpu_torch" / "csrc" / "fused_adamw.cu").read_text()
    floats = "const void* scalars" not in src
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    twin.argtypes = ([ptr, i32, i64, i64, i32, i32] + [f32] * 9 + [ptr]
                     if floats else this.argtypes)
    twin.restype = i32
    dev = torch.device("cuda")
    shapes = [p.shape for p in GPT(gpt2_config("gpt2-1.3b")).parameters()]
    gen = torch.Generator(device=dev).manual_seed(12)
    gs = [(torch.randn(s, generator=gen, device=dev) * 1e-2).to(torch.bfloat16)
          for s in shapes]
    state = {"this": ([(torch.randn(s, generator=gen, device=dev) * 0.02)
                       .to(torch.bfloat16) for s in shapes],
                      [torch.randn(s, generator=gen, device=dev) * 1e-3
                       for s in shapes],
                      [torch.rand(s, generator=gen, device=dev) * 1e-5
                       for s in shapes])}
    state["other"] = tuple([x.clone() for x in xs] for xs in state["this"])
    lr, step, b1, b2, eps, wd = 2e-4, 4, 0.9, 0.95, 1e-8, 0.1
    c1, c2 = fadam._bias_corrections(step, b1, b2)
    scalars = fadam.adamw_scalars(lr, step, b1, b2, dev)
    tables = {who: fadam._table(list(zip(ps, gs, ms, vs)), dev)
              for who, (ps, ms, vs) in state.items()}
    stream = torch.cuda.current_stream().cuda_stream

    def call(who):
        table, rows, chunks = tables[who]
        head = (table.data_ptr(), rows, chunks, fadam.CHUNK, 1, 1)
        if who == "this" or not floats:
            err = (this if who == "this" else twin)(
                *head, scalars.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, wd, stream)
        else:
            err = twin(*head, lr, b1, 1 - b1, b2, 1 - b2, c1, c2, eps, wd, stream)
        if err:
            raise RuntimeError(f"fused_adamw ({who}) failed: CUDA error {err}")

    call("other")
    call("this")
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for xs, ys in zip(state["this"], state["other"])
               for x, y in zip(xs, ys))
    times, ratio = _in_turns(lambda: call("other"), lambda: call("this"))
    emit({"phase": "against", "kernel": "fused_adamw", "case": "gpt2_1p3b_leaves",
          "other_takes_host_floats": floats, "bit_identical": same,
          "other_ms": times["other"], "this_ms": times["this"],
          "this_over_other": ratio})
    return same


def phase_against(root):
    """The backward kernels (B2, B3, B6, B7) and the fused AdamW (B4) of
    this tree against those of the checkout at ``root``, built beside
    them, on the same tensors, in turns. Returns False if a check
    failed."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    other = _other_build(root)
    emit({"phase": "against", "other": str(root), "ptxas": _build_both(other)})
    ok = ab_flash(other)
    ok = ab_sparse(other) and ok
    free_cuda()
    return ab_adamw(other, root) and ok


# -- train_options: the GPT training options (ROADMAP A.6) ---------------------
# the "auto" selector's sweep: the flash kernels (B1; B1 + B2 + B3 with the
# backward) against the model's einsum path, causal, bf16, at a fixed token
# count per call (batch = SWEEP_TOKENS / T) and heads x D = SWEEP_WIDTH
SWEEP_SEQS = (128, 256, 384, 512, 768, 1024, 2048, 4096, 8192)
SWEEP_HEAD_DIMS = (64, 128)
SWEEP_TOKENS = 8192
SWEEP_WIDTH = 1024
# remat policies on GPT-2 1.3B's widths (gpt_pretrain.py's config, micro
# [4, 1024]) at OPTIONS_LAYERS of its 24 layers (the depth cut that makes
# room for later phases: PERF.md section 4), with each one's launches per
# step: selective and save_nothing_but_flash keep B1's o and lse, so B1
# runs once per layer; save_dots keeps every product, but a kernel is not a
# product, so B1 runs again in the recompute
OPTIONS_LAYERS = 12
OPTION_POLICIES = ("full", "selective", "save_nothing_but_flash", "save_dots")
POLICY_PER_STEP = {
    policy: {"flash_attention_fwd": OPTIONS_LAYERS if policy in (
        "selective", "save_nothing_but_flash") else 2 * OPTIONS_LAYERS,
             "flash_attention_bwd_dq": OPTIONS_LAYERS,
             "flash_attention_bwd_dkv": OPTIONS_LAYERS,
             "fused_adamw": 1}
    for policy in OPTION_POLICIES}
# dropout in training keeps attention on the einsum path (JAX's gate)
EINSUM_PER_STEP = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                   "flash_attention_bwd_dkv": 0, "fused_adamw": 1}
# GPT-2's published dropout (resid_pdrop, embd_pdrop, attn_pdrop:
# https://huggingface.co/openai-community/gpt2/blob/main/config.json)
OPTIONS_DROPOUT = 0.1
# a kept share further than this many binomial standard deviations from
# 1 - p fails
KEEP_SIGMAS = 6.0
OPTIONS_PLD = {"enabled": True, "theta": 0.5, "gamma": 0.001}
# the per-layer keep counts are taken on a small model of the family (eager
# steps, a forward pre-hook on each block reads its gate): full-size replays
# cannot show their gates, and 256 of their steps would take the phase's
# whole budget. The counts run under a faster schedule than the tutorial's
# (theta near 0.5 from step ~150 on), so that the last layer drops ~103
# times in 256 steps: a gate that never drops, or always drops, lies
# outside some layer's bound (under gamma 0.001 a gate that never dropped
# stayed within every layer's)
PLD_COUNT_STEPS = 256
PLD_COUNT_SCHEDULE = {"enabled": True, "theta": 0.5, "gamma": 0.02}
PLD_SMALL = dict(vocab_size=512, n_positions=128, n_embd=128, n_layer=8,
                 n_head=4)
PLD_SMALL_BERT = dict(vocab_size=512, hidden_size=128, num_hidden_layers=8,
                      num_attention_heads=4, intermediate_size=512,
                      max_position_embeddings=128)
# BLOOM-7b1 trains at full width through the fused head: 8 layers, micro
# [6, 2048], whose bf16 logits (6 x 2048 x 250880 x 2 = 6.17e9 bytes) pass
# the 4 GiB point of fused_head_ce="auto"; [4, 2048] (4.11e9) would not
BLOOM_TRAIN_LAYERS = 8
BLOOM_MICRO = 6
# fused head against the unfused one, at a micro batch both fit
BLOOM_CMP_MICRO = 2
# the fused head computes each logit with the same bf16 product as the
# unfused head, but a chunk's GEMM may take another cuBLAS tiling, and dw
# sums over chunks in f32 where the unfused head's one product rounds once
# to bf16: the loss agrees to TRAIN_LOSS_REL_TOL, the gradients to the
# bf16 rounding of their largest entries (relative L2)
FUSED_GRAD_REL_L2 = 2e-2
# Mistral-7B's widths, 8 layers, [2, 4096]: chunked attention at 1024
# against flash
OPTIONS_CHUNK = 1024
MISTRAL_FWD_MICRO = 1


def flash_auto_sweep():
    """The flash kernels against the einsum path over ``SWEEP_SEQS`` at D 64
    and 128, forward alone and forward + backward, by device time. Returns
    the sweep and the constants it implies: ``min_seq``, the shortest T from
    which flash wins forward + backward at every longer T of the sweep and
    both head dims, and ``max_seq``, the longest T at which it still wins
    (the sweep's last when it wins throughout)."""
    import torch

    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator().manual_seed(3)
    rows, wins = [], {}
    for d in SWEEP_HEAD_DIMS:
        h = SWEEP_WIDTH // d
        for t in SWEEP_SEQS:
            b = max(1, SWEEP_TOKENS // t)
            q, k, v, do = (torch.randn((b, t, h, d), generator=gen).to(
                "cuda", torch.bfloat16) for _ in range(4))
            for x in (q, k, v):
                x.requires_grad_(True)

            def flash():
                return fa.flash_attention(q, k, v, causal=True)

            def einsum():
                return tlm.einsum_attention(q, k, v, causal=True)

            row = {"d": d, "t": t, "shape": [b, t, h, d]}
            iters = 10 if t <= 2048 else 4
            for name, fn in (("flash", flash), ("einsum", einsum)):
                with torch.no_grad():
                    row[f"{name}_fwd_ms"] = device_ms(fn, iters=iters)["ms"]
                row[f"{name}_fwd_bwd_ms"] = device_ms(
                    lambda: torch.autograd.grad(fn(), (q, k, v), do),
                    iters=iters)["ms"]
            row["flash_wins_fwd"] = row["flash_fwd_ms"] < row["einsum_fwd_ms"]
            row["flash_wins_fwd_bwd"] = (row["flash_fwd_bwd_ms"]
                                         < row["einsum_fwd_bwd_ms"])
            wins[(d, t)] = row["flash_wins_fwd_bwd"]
            rows.append(row)
            del q, k, v, do
            free_cuda()
    seqs = list(SWEEP_SEQS)
    min_seq = next((t for i, t in enumerate(seqs)
                    if all(wins[(d, s)] for d in SWEEP_HEAD_DIMS
                           for s in seqs[i:])), None)
    won = [t for t in seqs if all(wins[(d, t)] for d in SWEEP_HEAD_DIMS)]
    result = {"phase": "kernel", "part": "flash_auto_sweep", "rows": rows,
              "tokens_per_call": SWEEP_TOKENS, "heads_x_d": SWEEP_WIDTH,
              "implied_min_seq": min_seq,
              "implied_max_seq": max(won) if won else None,
              "model_constants": {"FLASH_AUTO_MIN_SEQ": tlm.FLASH_AUTO_MIN_SEQ,
                                  "FLASH_MAX_SEQ": tlm.FLASH_MAX_SEQ,
                                  "CHUNKED_AUTO_CHUNK":
                                      tlm.CHUNKED_AUTO_CHUNK},
              "smi": nvidia_smi_line()}
    emit(result)
    return result


def options_engine(seed=0, config=None, **model_over):
    """GPT-2 1.3B's widths at ``OPTIONS_LAYERS`` layers through
    ``initialize`` with ``GPT_PRETRAIN_CONFIG`` (or ``config``), as
    ``gpt_pretrain.py`` builds it (full remat,
    ``use_flash_attention="auto"``), with ``model_over`` on the config."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT, gpt2_config

    fields = dict(n_positions=1024, n_layer=OPTIONS_LAYERS,
                  dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16, remat=True, remat_policy="full",
                  use_flash_attention="auto")
    fields.update(model_over)
    return deepspeed_tpu_torch.initialize(
        model=GPT(gpt2_config("gpt2-1.3b", **fields)),
        config=config or GPT_PRETRAIN_CONFIG, seed=seed)[0]


def lm_batch(vocab, micro, seq, seed=1):
    import numpy as np

    ids = np.random.RandomState(seed).randint(
        0, vocab, size=(micro, seq)).astype(np.int64)
    return {"input_ids": ids, "labels": ids}


def options_pair(make_engine, batch, per_step, probe=None, after=None):
    """``captured_against_eager`` over ``STEPS`` steps on a repeated batch
    (2 warm-up, the capture, 9 replays) as one line: the launches, the
    medians, the peaks, the identity, and ``probe(engine)``'s values before
    every step of both runs (which must agree). ``after(engine, it)``'s
    dict joins the line; it runs on the captured engine after its steps,
    once the final parameters are copied. Returns the line, the captured
    run's final parameters and the problems found."""
    import numpy as np

    import torch

    probes, kept = [], {}

    def traced(engine, it):
        kept.update((k, v.clone()) for k, v in engine.params.items())
        if after is not None:
            kept["line"] = after(engine, it)

    torch.cuda.reset_peak_memory_stats()
    check, launches, losses, norms, times, e_losses, e_times = \
        captured_against_eager(
            make_engine, [batch], STEPS, traced=traced,
            probe=None if probe is None else
            (lambda engine: probes.append(probe(engine))))
    line = {"launches": launches,
            "launches_per_step": {k: v / STEPS for k, v in launches.items()
                                  if k in per_step},
            "losses": losses, "grad_norms": norms,
            "step_ms_median": statistics.median(times[CAPTURE_WARMUP + 1:]),
            "eager_step_ms_median":
                statistics.median(e_times[CAPTURE_WARMUP + 1:]),
            "capture_step_ms": times[CAPTURE_WARMUP],
            **{k: check[k] for k in (
                "state_gb", "peak_allocated_gb", "eager_peak_allocated_gb",
                "eager_peak_above_state_gb", "identical",
                "first_param_difference")},
            **kept.pop("line", {})}
    problems = [f"{name}: {launches[name]} launches, want {per} x {STEPS}"
                for name, per in {**per_step, **UNSEGMENTED}.items()
                if launches[name] != per * STEPS]
    if not all(np.isfinite(losses)):
        problems.append("non-finite loss")
    if probe is not None:
        line["probes"] = probes[:STEPS]
        if probes[:STEPS] != probes[STEPS:]:
            problems.append("the probes differ between captured and eager")
    if not check["identical"]:
        problems.append("captured and eager steps differ")
    return line, kept, problems


# cuBLAS's GEMM kernels on Hopper, by name
GEMM_KERNEL_MARKS = ("gemm", "nvjet", "xmma", "cutlass")


def traced_gemms(engine, it):
    """One traced replay: the card's time, and the part of it in GEMM
    kernels (what a remat policy's recompute saves or spends)."""
    summary, by_name, _ = _trace(lambda: engine.train_batch(it))
    gemm = sum(ms for name, ms in by_name.items()
               if any(m in name.lower() for m in GEMM_KERNEL_MARKS))
    return {"traced_replay": summary, "traced_gemm_ms": gemm}


def options_policies(batch):
    """GPT-2 1.3B under each remat policy: the launches per step, captured
    against eager, and every policy's losses, grad norms and final
    parameters bit for bit against ``full``'s (a policy changes what is
    saved, never a value). Returns the launch counts by policy and the
    problems found."""
    counts, problems = {}, []
    full = None
    for policy in OPTION_POLICIES:
        line, params, probs = options_pair(
            functools.partial(options_engine, remat_policy=policy), batch,
            POLICY_PER_STEP[policy], after=traced_gemms)
        line["tokens_per_s"] = 4 * 1024 / line["step_ms_median"] * 1e3
        problems += [f"{policy}: {p}" for p in probs]
        if full is None:
            full = (line, params)
        else:
            ref, ref_params = full
            diff = first_difference(ref_params, params)
            line["equals_full"] = {
                "losses": line["losses"] == ref["losses"],
                "grad_norms": line["grad_norms"] == ref["grad_norms"],
                "params": diff is None, "first_param_difference": diff}
            if not all(v for k, v in line["equals_full"].items()
                       if k != "first_param_difference"):
                problems.append(f"{policy}: differs from full")
            line["peak_vs_full_gb"] = (line["eager_peak_above_state_gb"]
                                       - ref["eager_peak_above_state_gb"])
            line["step_vs_full"] = (line["step_ms_median"]
                                    / ref["step_ms_median"])
        del params
        counts[policy] = line["launches"]
        emit({"phase": "train_options", "part": "remat_policy",
              "policy": policy, **line})
    del full
    free_cuda()
    return counts, problems


def _kept_shares(engine, batch):
    """Each dropout site's kept share in one eager training forward of
    ``engine``'s model (the masks read where they are drawn)."""
    import torch

    from deepspeed_tpu_torch.runtime import activation_checkpointing as ac

    shares, draw = [], ac.bernoulli_mask

    def counted(shape, p, generator, device):
        mask = draw(shape, p, generator, device)
        shares.append((float(mask.float().mean()), mask.numel(), p))
        return mask

    ac.bernoulli_mask = counted
    try:
        with torch.no_grad():
            ids = torch.as_tensor(batch["input_ids"], device="cuda")
            engine.module.train()
            engine.module(ids, labels=ids,
                          dropout_generator=engine._dropout_gen)
    finally:
        ac.bernoulli_mask = draw
    return shares


def options_dropout(batch):
    """GPT-2 1.3B at dropout 0.1 (einsum attention: B1-B3 0): captured
    against eager over 12 steps; at lr 0 two replays give different losses
    (different masks); each site's kept share within ``KEEP_SIGMAS`` of 0.9;
    the same 12 steps without remat bit for bit (the recompute sees the
    forward's masks); a small GPT saved and resumed continues the mask
    stream bit for bit."""
    import math as _m

    problems = []

    def after(engine, it):
        engine.set_lr(0.0)
        frozen = [float(engine.train_batch(it)) for _ in range(2)]
        shares = _kept_shares(engine, batch)
        bad = [i for i, (share, n, p) in enumerate(shares)
               if abs(share - p) > KEEP_SIGMAS * _m.sqrt(p * (1 - p) / n)]
        return {"lr0_replay_losses": frozen,
                "replays_draw_different_masks": frozen[0] != frozen[1],
                "sites": len(shares),
                "kept_share_min_max": [min(s for s, _, _ in shares),
                                       max(s for s, _, _ in shares)],
                "sites_outside_bound": bad}

    line, params, probs = options_pair(
        functools.partial(options_engine, dropout=OPTIONS_DROPOUT), batch,
        EINSUM_PER_STEP, after=after)
    line["tokens_per_s"] = 4 * 1024 / line["step_ms_median"] * 1e3
    problems += probs
    if not line["replays_draw_different_masks"]:
        problems.append("two replays drew the same masks")
    if line["sites"] != 1 + 3 * OPTIONS_LAYERS or line["sites_outside_bound"]:
        problems.append(f"kept shares: {line['sites']} sites, outside "
                        f"{line['sites_outside_bound']}")
    # the same steps without recomputation, uncaptured
    import torch

    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    torch.cuda.reset_peak_memory_stats()
    plain = options_engine(dropout=OPTIONS_DROPOUT, remat=False)
    losses, norms, times = train_steps(
        plain, iter(RepeatingLoader([batch])), STEPS, eager=True)
    diff = first_difference(params, plain.params)
    line["remat_off"] = {
        "losses_equal": [float(x) for x in losses] == line["losses"],
        "grad_norms_equal": [float(x) for x in norms] == line["grad_norms"],
        "params_equal": diff is None, "first_param_difference": diff,
        "step_ms_median": statistics.median(times[CAPTURE_WARMUP + 1:]),
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    del plain, params
    free_cuda()
    if not all(line["remat_off"][k] for k in
               ("losses_equal", "grad_norms_equal", "params_equal")):
        problems.append("remat on and off differ under dropout")
    line["resume"] = dropout_resume()
    if not line["resume"]["continues_bit_for_bit"]:
        problems.append("a resume does not continue the mask stream")
    emit({"phase": "train_options", "part": "dropout",
          "dropout": OPTIONS_DROPOUT, **line})
    return line, problems


def dropout_resume():
    """A small dropout GPT: 4 steps, a tag, 3 more steps; a fresh engine
    from another seed loads the tag and takes the same 3 steps: losses and
    parameters bit for bit (the tag holds the dropout generator's state)."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT, GPTConfig
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    path = os.path.join("build", "chip_smoke_dropout")
    shutil.rmtree(path, ignore_errors=True)
    batch = lm_batch(PLD_SMALL["vocab_size"], 4, 128, seed=4)

    def engine(seed):
        cfg = GPTConfig(**PLD_SMALL, dtype=torch.bfloat16, remat=True,
                        dropout=OPTIONS_DROPOUT, use_flash_attention="auto")
        return deepspeed_tpu_torch.initialize(
            model=GPT(cfg), config=dict(GPT_PRETRAIN_CONFIG,
                                        zero_optimization={"stage": 0}),
            seed=seed)[0]

    try:
        a = engine(0)
        it = iter(RepeatingLoader([batch]))
        for _ in range(4):
            a.train_batch(it)
        a.save_checkpoint(path)
        want = [float(a.train_batch(it)) for _ in range(3)]
        b = engine(5)
        b.load_checkpoint(path)
        got = [float(b.train_batch(iter(RepeatingLoader([batch]))))
               for _ in range(3)]
        diff = first_difference(a.params, b.params)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return {"losses_after_save": want, "losses_after_resume": got,
            "continues_bit_for_bit": want == got and diff is None}


def pld_keep_counts(family):
    """A small stochastic-mode model (``family`` "gpt": ``PLD_SMALL``;
    "bert": ``PLD_SMALL_BERT`` with dropout 0.1) under
    ``PLD_COUNT_SCHEDULE``, ``PLD_COUNT_STEPS`` eager steps: each block's
    gate read by a forward pre-hook, each layer's keep count against the
    sum of its keep probabilities (binomial bound), whether a gate that
    never drops or always drops would lie outside the bound, and the device
    theta against the host schedule at every step."""
    import math as _m

    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import (
        GPT, GPTConfig, pld_keep_probability)
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    config = dict(GPT_PRETRAIN_CONFIG, zero_optimization={"stage": 0},
                  progressive_layer_drop=PLD_COUNT_SCHEDULE)
    if family == "bert":
        from deepspeed_tpu_torch.models.bert import (BertConfig,
                                                     BertForPreTraining)

        cfg = BertConfig(**PLD_SMALL_BERT, dtype=torch.bfloat16,
                         stochastic_mode=True, dropout=BERT_DROPOUT)
        model, n_layer = BertForPreTraining(cfg), cfg.num_hidden_layers
        blocks = model.encoder.layer
        batch = mlm_batch(4, 128, seed=6, vocab=cfg.vocab_size)
    else:
        cfg = GPTConfig(**PLD_SMALL, dtype=torch.bfloat16,
                        stochastic_mode=True, use_flash_attention="auto")
        model, n_layer, blocks = GPT(cfg), cfg.n_layer, None
        batch = lm_batch(cfg.vocab_size, 4, 128, seed=6)
    engine = deepspeed_tpu_torch.initialize(model=model, config=config,
                                            seed=2)[0]
    if blocks is None:
        blocks = engine.module.h
    kept = [0] * n_layer
    hooks = []
    for i, block in enumerate(blocks):
        def hook(mod, args, kwargs, i=i):
            # a GPT block takes its gate by keyword, a BERT layer as its
            # fourth argument
            gate = kwargs.get("gate", args[3] if len(args) > 3 else None)
            kept[i] += int(bool(gate))
        hooks.append(block.register_forward_pre_hook(hook, with_kwargs=True))
    expect = [0.0] * n_layer
    var = [0.0] * n_layer
    theta_err = 0.0
    it = iter(RepeatingLoader([batch]))
    for _ in range(PLD_COUNT_STEPS):
        host = engine.progressive_layer_drop.get_theta()
        theta_err = max(theta_err, abs(float(engine.pld_theta()) - host))
        for i in range(n_layer):
            p = pld_keep_probability(i, n_layer, host)
            expect[i] += p
            var[i] += p * (1 - p)
        engine._train_batch(it, eager=True)
    for h in hooks:
        h.remove()
    bound = [KEEP_SIGMAS * _m.sqrt(v) + 0.5 for v in var]
    bad = [i for i in range(n_layer) if abs(kept[i] - expect[i]) > bound[i]]
    del engine
    return {"family": family, "steps": PLD_COUNT_STEPS,
            "schedule": PLD_COUNT_SCHEDULE, "kept": kept, "expected": expect,
            "bound": bound, "layers_outside_bound": bad,
            "never_drop_caught": any(PLD_COUNT_STEPS - e > b
                                     for e, b in zip(expect, bound)),
            "always_drop_caught": any(e > b for e, b in zip(expect, bound)),
            "device_vs_host_theta_max_abs": theta_err}


def keep_count_problems(counts):
    """The failed checks of a ``pld_keep_counts`` reading."""
    if (counts["layers_outside_bound"] or not counts["never_drop_caught"]
            or not counts["always_drop_caught"]
            or counts["device_vs_host_theta_max_abs"] > 1e-6):
        return [f"PLD keep counts: {counts}"]
    return []


def options_pld(batch):
    """GPT-2 1.3B with stochastic_mode under progressive_layer_drop (theta
    0.5, gamma 0.001), flash on: B1 24 / B2 12 / B3 12 / B4 1 (the blocks
    always run), captured against eager, the device theta against the host
    schedule before every step; then the per-layer keep counts on a small
    GPT (``pld_keep_counts``)."""
    problems = []

    def probe(engine):
        return [float(engine.pld_theta()),
                engine.progressive_layer_drop.get_theta()]

    config = dict(GPT_PRETRAIN_CONFIG, progressive_layer_drop=OPTIONS_PLD)
    line, params, probs = options_pair(
        functools.partial(options_engine, config=config,
                          stochastic_mode=True),
        batch, POLICY_PER_STEP["full"], probe=probe)
    del params
    line["tokens_per_s"] = 4 * 1024 / line["step_ms_median"] * 1e3
    problems += probs
    # the device computes theta in f32, the host in f64
    line["theta_max_abs_diff"] = max(abs(d - h) for d, h in line["probes"])
    if line["theta_max_abs_diff"] > 1e-6:
        problems.append("device pld_theta departs from the host schedule")
    line["keep_counts"] = pld_keep_counts("gpt")
    problems += keep_count_problems(line["keep_counts"])
    free_cuda()
    emit({"phase": "train_options", "part": "progressive_layer_drop",
          "pld": OPTIONS_PLD, **line})
    return line, problems


def bloom_train_engine(seed=0, micro=BLOOM_MICRO, **over):
    """BLOOM-7b1's widths at ``BLOOM_TRAIN_LAYERS`` layers through
    ``initialize`` with ``GPT_PRETRAIN_CONFIG`` at ``micro``, full remat,
    ``fused_head_ce`` "auto" unless ``over`` says otherwise."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT

    fields = dict(n_layer=BLOOM_TRAIN_LAYERS, remat=True)
    fields.update(over)
    return deepspeed_tpu_torch.initialize(
        model=GPT(neox_config(BLOOM_7B1, **fields)),
        config=dict(GPT_PRETRAIN_CONFIG, train_micro_batch_size_per_gpu=micro),
        seed=seed)[0]


def bloom_fused_against_unfused():
    """At micro [2, 2048] the fused head (``fused_head_ce=True``) against
    the unfused one on the same BLOOM weights: the loss, the tied
    embedding's and the last layer's gradients, and each head's peak
    memory above the model's."""
    import dataclasses as _dc

    import torch

    from deepspeed_tpu_torch.models.transformer_lm import GPT, materialize_gpt

    free_cuda()
    cfg = neox_config(BLOOM_7B1, n_layer=BLOOM_TRAIN_LAYERS, remat=True,
                      fused_head_ce=True)
    fused = GPT(cfg)
    materialize_gpt(fused, torch.device("cuda"),
                    torch.Generator(device="cuda").manual_seed(0))
    unfused = GPT(_dc.replace(cfg, fused_head_ce=False))
    unfused.load_state_dict(fused.state_dict(), assign=True)
    batch = lm_batch(cfg.vocab_size, BLOOM_CMP_MICRO, NEOX_SEQ, seed=7)
    ids = torch.as_tensor(batch["input_ids"], device="cuda")
    out = {}
    for name, model in (("fused", fused), ("unfused", unfused)):
        model.train()
        for p in model.parameters():
            p.requires_grad_(True)
            p.grad = None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = model(ids, labels=ids)
        loss.backward()
        torch.cuda.synchronize()
        out[name] = {
            "loss": float(loss),
            "peak_above_model_gb":
                (torch.cuda.max_memory_allocated() - base) / 1e9,
            "grads": {"wte": model.wte.weight.grad.clone(),
                      **{f"h.{len(model.h) - 1}.{n}": p.grad.clone()
                         for n, p in model.h[-1].named_parameters()}}}
        for p in model.parameters():
            p.grad = None
    rel = {k: _rel_l2(out["fused"]["grads"][k], out["unfused"]["grads"][k])
           for k in out["fused"]["grads"]}
    result = {"batch": [BLOOM_CMP_MICRO, NEOX_SEQ],
              "loss": [out["fused"]["loss"], out["unfused"]["loss"]],
              "peak_above_model_gb": [out["fused"]["peak_above_model_gb"],
                                      out["unfused"]["peak_above_model_gb"]],
              "grad_rel_l2_max": max(rel.values()),
              "grad_rel_l2_worst": max(rel, key=rel.get)}
    del fused, unfused, out
    free_cuda()
    return result


def options_bloom():
    """BLOOM-7b1 trains at full width, 8 layers, micro [6, 2048] (einsum
    attention under ALiBi: B1-B3 0, B4 1): ``"auto"`` must engage the fused
    head (its calls counted in the captured run's warm-up); then the fused
    head against the unfused one at micro 2."""
    import torch

    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.ops import cross_entropy as ce

    problems = []
    cfg = neox_config(BLOOM_7B1, n_layer=BLOOM_TRAIN_LAYERS)
    chunk = tlm.fused_head_engages(cfg, BLOOM_MICRO, NEOX_SEQ)
    calls = [0]
    real = ce.fused_linear_cross_entropy

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    ce.fused_linear_cross_entropy = counted
    try:
        line, params, probs = options_pair(
            bloom_train_engine,
            lm_batch(cfg.vocab_size, BLOOM_MICRO, NEOX_SEQ),
            EINSUM_PER_STEP)
    finally:
        ce.fused_linear_cross_entropy = real
    del params
    problems += probs
    tokens = BLOOM_MICRO * NEOX_SEQ
    logits_bytes = tokens * cfg.vocab_size * 2
    line.update(model=f"bloom-7b1, {BLOOM_TRAIN_LAYERS} layers",
                source=BLOOM_SOURCE,
                reduced={"n_layer": f"30 -> {BLOOM_TRAIN_LAYERS}"},
                batch=[BLOOM_MICRO, NEOX_SEQ], logits_bytes=logits_bytes,
                fused_chunk=chunk, fused_head_calls=calls[0],
                tokens_per_s=tokens / line["step_ms_median"] * 1e3,
                model_tflops_per_s=tokens * gpt_flops_per_token(
                    cfg, NEOX_SEQ) / line["step_ms_median"] / 1e9)
    # every uncaptured call of the step (2 warm-ups, the capture, the
    # eager twin's 12) goes through the fused head; replays call nothing
    if chunk != tlm.FUSED_HEAD_CE_CHUNK or calls[0] != 3 + STEPS:
        problems.append(f"fused head not engaged: chunk {chunk}, "
                        f"{calls[0]} calls")
    if not line["losses"][-1] <= line["losses"][0] - TRAIN_MIN_LOSS_DROP:
        problems.append("BLOOM loss did not fall")
    line["fused_vs_unfused"] = cmp = bloom_fused_against_unfused()
    if abs(cmp["loss"][0] - cmp["loss"][1]) > \
            TRAIN_LOSS_REL_TOL * abs(cmp["loss"][1]):
        problems.append("fused and unfused losses disagree")
    if cmp["grad_rel_l2_max"] > FUSED_GRAD_REL_L2:
        problems.append("fused and unfused gradients disagree")
    emit({"phase": "train_options", "part": "bloom_fused_head", **line})
    return line, problems


def options_mistral():
    """Mistral-7B's widths, 8 layers, [2, 4096]: ``attention_chunk=1024``
    (B1-B3 0, B4 1) against the flash run (the first step's loss and grad
    norm, both step medians); then ``forward`` at all 32 layers, chunked
    against flash, on [1, 4096]."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT

    problems = []

    def engine(chunk, seed=0):
        model = GPT(mistral_config(n_layer=MISTRAL_TRAIN_LAYERS, remat=True,
                                   attention_chunk=chunk))
        config = dict(GPT_PRETRAIN_CONFIG,
                      train_micro_batch_size_per_gpu=MISTRAL_MICRO)
        return deepspeed_tpu_torch.initialize(model=model, config=config,
                                              seed=seed)[0]

    batch = lm_batch(MISTRAL_7B["vocab_size"], MISTRAL_MICRO, MISTRAL_SEQ)
    chunked, params, probs = options_pair(
        functools.partial(engine, OPTIONS_CHUNK), batch, EINSUM_PER_STEP)
    del params
    problems += probs
    flash, params, probs = options_pair(
        functools.partial(engine, None), batch, MISTRAL_PER_STEP)
    del params
    problems += probs
    tokens = MISTRAL_MICRO * MISTRAL_SEQ
    line = {"model": f"mistral-7b-v0.1, {MISTRAL_TRAIN_LAYERS} layers",
            "batch": [MISTRAL_MICRO, MISTRAL_SEQ], "chunk": OPTIONS_CHUNK,
            "chunked": chunked, "flash": flash,
            "first_loss": [chunked["losses"][0], flash["losses"][0]],
            "first_grad_norm": [chunked["grad_norms"][0],
                                flash["grad_norms"][0]],
            "tokens_per_s": [tokens / chunked["step_ms_median"] * 1e3,
                             tokens / flash["step_ms_median"] * 1e3]}
    if abs(chunked["losses"][0] - flash["losses"][0]) > \
            TRAIN_LOSS_REL_TOL * abs(flash["losses"][0]):
        problems.append("chunked and flash losses disagree")
    if abs(chunked["grad_norms"][0] - flash["grad_norms"][0]) > \
            TRAIN_GNORM_REL_TOL * abs(flash["grad_norms"][0]):
        problems.append("chunked and flash grad norms disagree")
    # the forward at all 32 layers
    free_cuda()
    ids = torch.as_tensor(lm_batch(MISTRAL_7B["vocab_size"],
                                   MISTRAL_FWD_MICRO, MISTRAL_SEQ,
                                   seed=2)["input_ids"], device="cuda")
    logits, fwd_ms = {}, {}
    for name, chunk in (("flash", None), ("chunked", OPTIONS_CHUNK)):
        infer = deepspeed_tpu_torch.init_inference(
            GPT(mistral_config(attention_chunk=chunk)), dtype="bf16")
        reset_launches()
        with torch.no_grad():
            logits[name] = infer(ids).float().cpu()
        line[f"forward_{name}_b1_launches"] = read_launches()[
            "flash_attention_fwd"]
        fwd_ms[name] = wall_ms(lambda: infer(ids), reps=3)
        del infer
        free_cuda()
    line["forward_32_layers"] = {
        "batch": [MISTRAL_FWD_MICRO, MISTRAL_SEQ], "ms": fwd_ms,
        "logits_rel_l2": _rel_l2(logits["chunked"], logits["flash"])}
    if line["forward_32_layers"]["logits_rel_l2"] > MISTRAL_LOGITS_REL_L2:
        problems.append("chunked and flash 32-layer logits disagree")
    if line["forward_chunked_b1_launches"] or \
            line["forward_flash_b1_launches"] != 32:
        problems.append("forward routes: chunked must launch no B1, flash 32")
    emit({"phase": "train_options", "part": "attention_chunk", **line})
    return line, problems


def phase_train_options():
    """The GPT training options of ROADMAP A.6 on the card (see the module
    docstring). Returns the launch counts by path: each run's counts set to
    0 just before its captured steps and read just after."""
    t0 = time.perf_counter()
    problems = []
    batch = lm_batch(50257, 4, 1024)
    counts, probs = options_policies(batch)
    problems += probs
    paths = {f"remat_{p}": c for p, c in counts.items()}
    line, probs = options_dropout(batch)
    problems += probs
    paths["dropout"] = line["launches"]
    line, probs = options_pld(batch)
    problems += probs
    paths["pld"] = line["launches"]
    line, probs = options_bloom()
    problems += probs
    paths["bloom_fused_head"] = line["launches"]
    line, probs = options_mistral()
    problems += probs
    paths["attention_chunk"] = line["chunked"]["launches"]
    emit({"phase": "train_options", "part": "summary",
          "seconds": time.perf_counter() - t0, "problems": problems,
          "smi": nvidia_smi_line()})
    if problems:
        raise AssertionError(f"train_options: {problems}")
    return paths


# The GPT block-sparse route (ROADMAP A.6): Mistral-7B-v0.1 at its published
# n_positions 32768 under a causal sliding window of 32 past blocks of 128
# plus the query's own (4096-4223 keys: the block-granular form of the
# published sliding_window 4096, a superset of it), on B5-B7
SPARSE_GPT_BLOCK = {"mode": "local_sliding_window", "block": 128,
                    "num_sliding_window_blocks": 65, "kernel": "pallas"}
SPARSE_GPT_POSITIONS = 32768
# serving's depth cut (from 32 layers; PERF.md section 4): every check of
# the serving part is per layer or on the whole stack's output
SPARSE_GPT_SERVE_LAYERS = 8
SPARSE_GPT_SEQ = 16384
# ring_engaged: (past window blocks, leading global tokens, block)
SPARSE_GPT_RING = (32, 0, 128)
SPARSE_GPT_RING_SLOTS = 4224
SPARSE_GPT_PROMPT_LENGTHS = (4500, 5000, 5500, 6000)
SPARSE_GPT_PER_STEP = {"block_sparse_fwd": 2 * MISTRAL_TRAIN_LAYERS,
                       "block_sparse_dq": MISTRAL_TRAIN_LAYERS,
                       "block_sparse_dkv": MISTRAL_TRAIN_LAYERS,
                       "fused_adamw": 1, "flash_attention_fwd": 0,
                       "flash_attention_bwd_dq": 0,
                       "flash_attention_bwd_dkv": 0}
# the kernels' first step against the gather path's: the gathered f32
# scores of one layer take 8.9 GB per tensor at 16384 (several live in its
# backward, beside 24 GB of ZeRO-1 state), so the pair runs at the
# shortest length the window's layout takes (65 blocks) rounded up: 66
SPARSE_GPT_CMP_SEQ = 66 * 128
SPARSE_GPT_FLASH_STEPS = 6


def sparse_gpt_model(kernel="pallas", **over):
    """Mistral-7B at n_positions 32768 rebuilt by ``apply_sparse_attention``
    with ``SPARSE_GPT_BLOCK`` on ``kernel``."""
    from deepspeed_tpu_torch.models.transformer_lm import GPT
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils \
        import apply_sparse_attention

    return apply_sparse_attention(
        GPT(mistral_config(n_positions=SPARSE_GPT_POSITIONS, **over)),
        dict(SPARSE_GPT_BLOCK, kernel=kernel))


def sparse_gpt_flops_per_token(cfg, seq):
    """6N (non-embedding) plus the attention term of ``gpt_flops_per_token``
    scaled to the causal visible pairs of the window, and the full causal
    count beside it."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        LocalSlidingWindowSparsityConfig

    block = SPARSE_GPT_BLOCK["block"]
    layout = LocalSlidingWindowSparsityConfig(
        num_heads=1, block=block,
        num_sliding_window_blocks=SPARSE_GPT_BLOCK[
            "num_sliding_window_blocks"]).make_layout(seq)
    share = visible_pairs(layout, block, 1, causal=True) / (seq * (seq + 1) // 2)
    full = gpt_flops_per_token(cfg, seq)
    attn = 6 * cfg.n_layer * cfg.n_embd * seq
    return {"model_6n_plus_visible_attention": full - attn + share * attn,
            "model_6n_plus_full_causal_attention": full,
            "visible_share": share}


def _cache_bytes(cache):
    return sum(t.numel() * t.element_size()
               for t in (*cache.key, *cache.value, cache.valid, cache.index,
                         getattr(cache, "slot_pos", None))
               if t is not None)


def sparse_gpt_serve():
    """Serving at ``SPARSE_GPT_SERVE_LAYERS`` layers through
    ``init_inference`` (bf16, seed 0): ``forward`` [1, 16384] on B5 (one
    launch per layer, no B1), its logits against
    the gather path's on the same weights, timed against the plain Mistral
    config's flash ``forward``; ``generate`` for 4 left-padded prompts of
    4500-6000 tokens (longer than the 4224-slot ring: 128-token prefill
    spans) and 32 greedy tokens, the decode graphs against eager decode,
    each decode step's logits against the gather forward's at the same
    positions, the ring's bytes against a dense cache's."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer_lm import GPT, RingKVCache
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils \
        import ring_engaged, ring_storage_len

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = init_inference(
        sparse_gpt_model(n_layer=SPARSE_GPT_SERVE_LAYERS), dtype="bf16",
        seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = engine.module.config
    ring = ring_engaged(cfg)
    problems = []
    if ring != SPARSE_GPT_RING or \
            ring_storage_len(cfg, ring) != SPARSE_GPT_RING_SLOTS:
        problems.append(f"ring {ring}, want {SPARSE_GPT_RING} and "
                        f"{SPARSE_GPT_RING_SLOTS} slots")
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (1, SPARSE_GPT_SEQ), generator=gen)
    width = max(SPARSE_GPT_PROMPT_LENGTHS)
    prompts = torch.randint(0, cfg.vocab_size,
                            (len(SPARSE_GPT_PROMPT_LENGTHS), width),
                            generator=gen)
    mask = torch.arange(width)[None, :] >= \
        width - torch.tensor(SPARSE_GPT_PROMPT_LENGTHS)[:, None]
    prompts = prompts * mask

    reset_launches()
    logits = engine(ids)
    torch.cuda.synchronize()
    forward_launches = read_launches()
    toks = engine.generate(prompts, max_new_tokens=MISTRAL_NEW_TOKENS,
                           attention_mask=mask)
    torch.cuda.synchronize()
    launches = read_launches()
    if forward_launches["block_sparse_fwd"] != cfg.n_layer or \
            forward_launches["flash_attention_fwd"]:
        problems.append(f"forward launched B5 "
                        f"{forward_launches['block_sparse_fwd']} and B1 "
                        f"{forward_launches['flash_attention_fwd']} times, "
                        f"want {cfg.n_layer} and 0")
    if not bool(torch.isfinite(logits).all()) or tuple(logits.shape) != (
            1, SPARSE_GPT_SEQ, cfg.vocab_size):
        problems.append(f"logits {tuple(logits.shape)} not finite")
    if tuple(toks.shape) != (len(SPARSE_GPT_PROMPT_LENGTHS),
                             MISTRAL_NEW_TOKENS):
        problems.append(f"generate returned {tuple(toks.shape)}")
    cache = engine._decoder(len(SPARSE_GPT_PROMPT_LENGTHS))[0]
    if not isinstance(cache, RingKVCache) or \
            cache.key[0].shape[1] != SPARSE_GPT_RING_SLOTS:
        problems.append(f"cache {type(cache).__name__} "
                        f"{tuple(cache.key[0].shape)}")
    ring_bytes = _cache_bytes(cache)
    dense_bytes = (2 * cfg.n_layer * len(SPARSE_GPT_PROMPT_LENGTHS)
                   * SPARSE_GPT_POSITIONS * cfg.kv_heads * cfg.head_dim * 2)

    # the kernels' logits against the gather path's, the same weights
    gather = init_inference(
        sparse_gpt_model("gather", n_layer=SPARSE_GPT_SERVE_LAYERS),
        dtype="bf16", state_dict=engine.module.state_dict())
    logits_g = gather(ids)
    gather_rel = _rel_l2(logits, logits_g)
    gather_top1 = float((logits.argmax(-1) == logits_g.argmax(-1))
                        .float().mean())
    del logits, logits_g
    free_cuda()
    forward_ms = wall_ms(lambda: engine(ids), reps=3)
    flash = init_inference(GPT(mistral_config(
        n_positions=SPARSE_GPT_POSITIONS, n_layer=SPARSE_GPT_SERVE_LAYERS)),
        dtype="bf16",
        state_dict=engine.module.state_dict())
    reset_launches()
    flash(ids)
    flash_b1 = read_launches()["flash_attention_fwd"]
    flash_forward_ms = wall_ms(lambda: flash(ids), reps=3)
    del flash
    free_cuda()

    decode = compare_decode(engine, prompts, mask, n=MISTRAL_NEW_TOKENS,
                            temperatures=(("greedy", 0.0),))
    dev = engine.device
    dec_logits, dec_toks, graph_same = mistral_decode_logits(
        engine, prompts.to(dev), mask.to(dev))
    # the training sparse forward over the same sequences, one row at a
    # time: the left-padded prompts, the fed tokens, right pads up to a
    # length the layout takes (>= 65 blocks)
    k = dec_toks.shape[1]
    t_ref = max(SPARSE_GPT_CMP_SEQ, -(-(width + k) // 128) * 128)
    rel, top1 = [], []
    with torch.inference_mode():
        for b in range(prompts.shape[0]):
            row = torch.zeros((1, t_ref), dtype=torch.long, device=dev)
            row_mask = torch.zeros((1, t_ref), dtype=torch.bool, device=dev)
            row[0, :width], row_mask[0, :width] = prompts[b], mask[b]
            row[0, width:width + k] = dec_toks[b]
            row_mask[0, width:width + k] = True
            full = gather.module(row, attention_mask=row_mask)
            want = full[0, width - 1:width + k]
            rel.append(_rel_l2(dec_logits[b], want))
            top1.append(float((dec_logits[b].argmax(-1) == want.argmax(-1))
                              .float().mean()))
            del full, want
    del gather, dec_logits
    free_cuda()
    n = MISTRAL_NEW_TOKENS
    gen1_ms = wall_ms(lambda: engine.generate(prompts, max_new_tokens=1,
                                              attention_mask=mask), reps=2)
    gen_ms = wall_ms(lambda: engine.generate(prompts, max_new_tokens=n,
                                             attention_mask=mask), reps=2)
    eager_ms = wall_ms(lambda: eager_generate(engine, prompts, n, mask),
                       reps=1)
    line = {"phase": "sparse_gpt", "part": "serve",
            "model": "mistral-7b-v0.1", "source": MISTRAL_SOURCE,
            "params": sum(p.numel() for p in engine.module.parameters()),
            "config": dict(MISTRAL_7B, n_positions=SPARSE_GPT_POSITIONS),
            "sparse_attention": SPARSE_GPT_BLOCK,
            "reduced": {"n_layer": f"32 -> {SPARSE_GPT_SERVE_LAYERS}"},
            "ring": list(ring), "ring_slots": ring_storage_len(cfg, ring),
            "dtype": "bf16", "init_s": init_s,
            "forward_shape": [1, SPARSE_GPT_SEQ],
            "forward_launches": forward_launches, "launches": launches,
            "kernels_vs_gather_logits_rel_l2": gather_rel,
            "kernels_vs_gather_top1_agreement": gather_top1,
            "logits_rel_l2_tol": MISTRAL_LOGITS_REL_L2,
            "forward_ms": forward_ms,
            "forward_tokens_per_s": SPARSE_GPT_SEQ / forward_ms * 1e3,
            "flash_full_causal_forward_ms": flash_forward_ms,
            "flash_forward_b1_launches": flash_b1,
            "prompt_lengths": list(SPARSE_GPT_PROMPT_LENGTHS),
            "new_tokens": n, "prefill_ms": gen1_ms,
            "decode_ms_per_token": (gen_ms - gen1_ms) / (n - 1),
            "eager_decode_ms_per_token": (eager_ms - gen1_ms) / (n - 1),
            "decode_graphs_vs_eager_tokens": decode,
            "decode_graphs_vs_eager_logits_identical": graph_same,
            "decode_vs_forward_logits_rel_l2": rel,
            "decode_vs_forward_top1_agreement": top1,
            "logit_steps": k, "forward_reference_length": t_ref,
            "ring_cache_gb": ring_bytes / 1e9,
            "dense_cache_gb_at_n_positions": dense_bytes / 1e9,
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(line)
    if not gather_rel <= MISTRAL_LOGITS_REL_L2:
        problems.append(f"kernels against gather: relative L2 {gather_rel}")
    if flash_b1 != cfg.n_layer:
        problems.append(f"the flash yardstick launched B1 {flash_b1} times")
    if not decode["identical"] or not all(graph_same):
        problems.append("decode graphs against eager decode differ")
    if not max(rel) <= MISTRAL_LOGITS_REL_L2:
        problems.append(f"ring decode against the forward: relative L2 {rel}")
    if problems:
        raise AssertionError(f"sparse_gpt serve: {problems}")
    del engine, cache
    free_cuda()
    return launches, line


def sparse_gpt_engine(kernel="pallas", attention=True):
    """The 8-layer cut through ``initialize`` with ``GPT_PRETRAIN_CONFIG``
    at micro 1 and the ``sparse_attention`` block on ``kernel`` (the engine
    rebuilds the model onto the route); ``attention=False``: the plain
    Mistral config (flash), the yardstick."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT

    model = GPT(mistral_config(n_layer=MISTRAL_TRAIN_LAYERS, remat=True,
                               n_positions=SPARSE_GPT_POSITIONS))
    config = dict(GPT_PRETRAIN_CONFIG, train_micro_batch_size_per_gpu=1)
    if attention:
        config["sparse_attention"] = dict(SPARSE_GPT_BLOCK, kernel=kernel)
    return deepspeed_tpu_torch.initialize(model=model, config=config)[0]


def sparse_gpt_train():
    """Training at 8 layers, micro [1, 16384]: the kernels' first step
    against the gather path's (loss, grad norm; at ``SPARSE_GPT_CMP_SEQ``),
    then 12 captured steps against 12 uncaptured ones (bit for bit), B5 16
    / B6 8 / B7 8 / B4 1 and no B1-B3 per step, the loss falling; the step
    time, tokens/s and model TFLOP/s over the visible pairs; the plain
    Mistral config's flash step at the same shape. Returns the captured
    run's launches and the line."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    problems = []
    cmp_batch = lm_batch(MISTRAL_7B["vocab_size"], 1, SPARSE_GPT_CMP_SEQ)
    first = {}
    for kernel in ("pallas", "gather"):
        free_cuda()
        engine = sparse_gpt_engine(kernel=kernel)
        first[kernel] = (float(engine.train_batch(iter([cmp_batch]))),
                         engine.get_global_grad_norm())
        del engine
    free_cuda()
    batch = lm_batch(MISTRAL_7B["vocab_size"], 1, SPARSE_GPT_SEQ)
    torch.cuda.reset_peak_memory_stats()
    check, launches, losses, norms, times, e_losses, e_times = \
        captured_against_eager(sparse_gpt_engine, [batch], STEPS)
    ms, eager_ms = step_medians(times, e_times)
    # the yardstick: the same widths on flash (B1-B3 over full causal)
    free_cuda()
    flash = sparse_gpt_engine(attention=False)
    f_losses, _, f_times = train_steps(
        flash, iter(RepeatingLoader([batch])), SPARSE_GPT_FLASH_STEPS)
    del flash
    free_cuda()
    flash_ms = statistics.median(f_times[CAPTURE_WARMUP + 1:])
    cfg = mistral_config(n_layer=MISTRAL_TRAIN_LAYERS)
    fpt = sparse_gpt_flops_per_token(cfg, SPARSE_GPT_SEQ)
    tokens = SPARSE_GPT_SEQ
    line = {"phase": "sparse_gpt", "part": "train",
            "model": f"mistral-7b-v0.1, {MISTRAL_TRAIN_LAYERS} layers",
            "reduced": {"n_layer": f"32 -> {MISTRAL_TRAIN_LAYERS}"},
            "config": dict(GPT_PRETRAIN_CONFIG,
                           train_micro_batch_size_per_gpu=1,
                           sparse_attention=SPARSE_GPT_BLOCK),
            "batch": [1, SPARSE_GPT_SEQ], "losses": losses,
            "eager_losses": e_losses, "captured_vs_eager": check,
            "launches": launches, "steps": STEPS,
            "step_ms_median": ms, "step_ms": times,
            "eager_step_ms_median": eager_ms,
            "tokens_per_s": tokens / ms * 1e3, "flops_per_token": fpt,
            "model_tflops_per_s": tokens * fpt[
                "model_6n_plus_visible_attention"] / ms / 1e9,
            "flash_full_causal_step_ms_median": flash_ms,
            "flash_full_causal_losses": [float(x) for x in f_losses],
            "flash_full_causal_tokens_per_s": tokens / flash_ms * 1e3,
            "flash_full_causal_model_tflops_per_s": tokens * fpt[
                "model_6n_plus_full_causal_attention"] / flash_ms / 1e9,
            "kernels_vs_gather_first_step": {
                "batch": [1, SPARSE_GPT_CMP_SEQ],
                "loss": [first["pallas"][0], first["gather"][0]],
                "grad_norm": [first["pallas"][1], first["gather"][1]]},
            "peak_allocated_gb": check["peak_allocated_gb"]}
    emit(line)
    if not all(np.isfinite(losses)):
        problems.append("non-finite loss")
    if not losses[-1] <= losses[0] - TRAIN_MIN_LOSS_DROP:
        problems.append(f"loss did not fall by {TRAIN_MIN_LOSS_DROP}")
    for name, per in {**SPARSE_GPT_PER_STEP, **UNSEGMENTED}.items():
        if launches[name] != per * STEPS:
            problems.append(f"{name}: {launches[name]} launches, want "
                            f"{per} x {STEPS}")
    (lp, gp), (lg, gg) = first["pallas"], first["gather"]
    if abs(lp - lg) > SPARSE_LOSS_REL_TOL * abs(lg):
        problems.append("kernels and gather losses disagree")
    if abs(gp - gg) > SPARSE_GNORM_REL_TOL * abs(gg):
        problems.append("kernels and gather grad norms disagree")
    if not check["identical"]:
        problems.append("captured and eager steps differ")
    if problems:
        raise AssertionError(f"sparse_gpt train: {problems}")
    return launches, line


def phase_sparse_gpt():
    """The GPT block-sparse route with the ring KV cache (ROADMAP A.6) on
    Mistral-7B's sliding window: serving at ``SPARSE_GPT_SERVE_LAYERS``
    layers, training at 8.
    Returns the launch counts of the serve and train runs."""
    import torch

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    serve, _ = sparse_gpt_serve()
    t_serve = time.perf_counter() - t0
    train, _ = sparse_gpt_train()
    emit({"phase": "sparse_gpt", "part": "done", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0, "serve_seconds": t_serve,
          "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"sparse_gpt_serve": serve, "sparse_gpt_train": train}


# BERT breadth (ROADMAP A.7): BERT-Large at full width and depth on B5-B7
# (BigBird block 128, [1, 4096]) under its published dropout
# (hidden_dropout_prob and attention_probs_dropout_prob 0.1:
# google-research/bert, bert_config.json of BERT-Large; the config has one
# dropout field), under each remat policy and under progressive layer drop
# with the DeepSpeed PLD tutorial's BERT settings
BERT_DROPOUT = 0.1
BERT_PLD = {"enabled": True, "theta": 0.5, "gamma": 0.001}
# a dense BERT-Large at [8, 512] (the einsum path, probability dropout on)
BERT_DENSE_MICRO, BERT_DENSE_SEQ = 8, 512
BERT_DENSE_PER_STEP = {"block_sparse_fwd": 0, "block_sparse_dq": 0,
                       "block_sparse_dkv": 0, "fused_adamw": 1,
                       "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                       "flash_attention_bwd_dkv": 0}


def bert_large_engine(seed=0, config=None, **over):
    """BERT-Large at ``SPARSE_SEQ`` positions through ``initialize`` with
    ``BERT_SPARSE_CONFIG`` (or ``config``): bf16, full remat unless
    ``over`` says otherwise."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import BertForPreTraining, bert_config

    fields = dict(dtype=torch.bfloat16, scan_layers=True, remat=True,
                  remat_policy="full", max_position_embeddings=SPARSE_SEQ)
    fields.update(over)
    return deepspeed_tpu_torch.initialize(
        model=BertForPreTraining(bert_config("bert-large", **fields)),
        config=config or BERT_SPARSE_CONFIG, seed=seed)[0]


def mlm_batch(rows, seq, seed=1, vocab=30522):
    """``rows`` x ``seq`` random ids with 15% of each row's positions
    labelled, the same count in every row as BERT's pretraining data
    masks a full-length sequence (so a data-parallel engine's global mean
    over the labelled tokens is the mean of the rows' means, as gradient
    accumulation takes it). No attention_mask: with one, the kernel route
    takes the dense path."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(rows, seq)).astype(np.int64)
    picked = rng.rand(rows, seq).argsort(axis=1)[:, :round(0.15 * seq)]
    labels = np.full_like(ids, -100)
    np.put_along_axis(labels, picked, np.take_along_axis(ids, picked, 1), 1)
    return {"input_ids": ids, "labels": labels}


def bert_policies(batch):
    """BERT-Large sparse at dropout 0.1 under each remat policy: captured
    against eager (``options_pair``), B5 48 / B6 24 / B7 24 / B4 1 per
    step, the loss falling, every policy's losses, grad norms and final
    parameters bit for bit ``full``'s (the same masks); after ``full``'s
    steps two replays at lr 0 draw different masks. Returns the lines by
    policy and the problems found."""
    problems, lines, full = [], {}, None

    def after(engine, it):
        engine.set_lr(0.0)
        frozen = [float(engine.train_batch(it)) for _ in range(2)]
        return {"lr0_replay_losses": frozen,
                "replays_draw_different_masks": frozen[0] != frozen[1]}

    for policy in OPTION_POLICIES:
        line, params, probs = options_pair(
            functools.partial(bert_large_engine, remat_policy=policy,
                              dropout=BERT_DROPOUT),
            batch, SPARSE_PER_STEP, after=after if full is None else None)
        problems += [f"{policy}: {p}" for p in probs]
        if not line["losses"][-1] <= line["losses"][0] - SPARSE_MIN_LOSS_DROP:
            problems.append(f"{policy}: the loss did not fall by "
                            f"{SPARSE_MIN_LOSS_DROP}")
        if full is None:
            full = (line, params)
            if not line["replays_draw_different_masks"]:
                problems.append("two replays drew the same masks")
        else:
            ref, ref_params = full
            diff = first_difference(ref_params, params)
            line["equals_full"] = {
                "losses": line["losses"] == ref["losses"],
                "grad_norms": line["grad_norms"] == ref["grad_norms"],
                "first_step_grad_norm": (line["grad_norms"][0]
                                         == ref["grad_norms"][0]),
                "params": diff is None, "first_param_difference": diff}
            if not all(v for k, v in line["equals_full"].items()
                       if k != "first_param_difference"):
                problems.append(f"{policy}: differs from full")
            line["activation_gb_vs_full"] = (
                line["eager_peak_above_state_gb"]
                - ref["eager_peak_above_state_gb"])
        del params
        line["tokens_per_s"] = SPARSE_SEQ / line["step_ms_median"] * 1e3
        lines[policy] = line
        emit({"phase": "bert_options", "part": "remat_policy",
              "policy": policy, "dropout": BERT_DROPOUT, **line})
    del full
    free_cuda()
    return lines, problems


def bert_dropout_checks(batch, full_line):
    """At the same weights and masks (one step each from seed 0): the
    kernels' loss and grad norm against the gather route's (``full``'s
    first step), and a dropout-0 engine's first loss, which must differ
    from the dropout-0.1 one."""
    import torch

    problems, out = [], {}
    loss_k, norm_k = full_line["losses"][0], full_line["grad_norms"][0]
    config = dict(BERT_SPARSE_CONFIG,
                  sparse_attention=dict(BIGBIRD_BLOCK, kernel="gather"))
    for name, engine in (
            ("gather", lambda: bert_large_engine(config=config,
                                                 dropout=BERT_DROPOUT)),
            ("dropout_0", lambda: bert_large_engine())):
        free_cuda()
        eng = engine()
        out[name] = [float(eng.train_batch(iter([batch]))),
                     eng.get_global_grad_norm()]
        del eng
    free_cuda()
    loss_g, norm_g = out["gather"]
    out["kernels_vs_gather"] = {
        "loss": [loss_k, loss_g], "grad_norm": [norm_k, norm_g],
        "loss_rel_err": abs(loss_k - loss_g) / abs(loss_g),
        "grad_norm_rel_err": abs(norm_k - norm_g) / abs(norm_g),
        "tolerance": {"loss_rel": SPARSE_LOSS_REL_TOL,
                      "grad_norm_rel": SPARSE_GNORM_REL_TOL}}
    if not out["kernels_vs_gather"]["loss_rel_err"] <= SPARSE_LOSS_REL_TOL:
        problems.append("kernels and gather losses disagree under dropout")
    if not out["kernels_vs_gather"]["grad_norm_rel_err"] <= \
            SPARSE_GNORM_REL_TOL:
        problems.append("kernels and gather grad norms disagree under "
                        "dropout")
    if out["dropout_0"][0] == loss_k:
        problems.append("the dropout-0 engine gave the dropout-0.1 loss")
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out, problems


def bert_pld(batch):
    """Stochastic depth under ``BERT_PLD`` with dropout 0.1: captured
    against eager, the device theta against the host schedule before every
    step of both runs, the layers each eager step dropped (the gates read
    as the encoder receives them, outside any capture), and the per-layer
    keep counts on a small BERT (``pld_keep_counts``)."""
    import math as _m

    import torch

    from deepspeed_tpu_torch.models.transformer_lm import pld_keep_probability

    problems, gates = [], []

    def probe(engine):
        enc = engine.module.encoder
        if not getattr(enc, "_gate_probe", False):
            def hook(mod, args):
                g = args[3] if len(args) > 3 else None
                if g is not None and \
                        not torch.cuda.is_current_stream_capturing():
                    gates.append((id(mod), g.clone()))
            enc.register_forward_pre_hook(hook)
            enc._gate_probe = True
        return [float(engine.pld_theta()),
                engine.progressive_layer_drop.get_theta()]

    config = dict(BERT_SPARSE_CONFIG, progressive_layer_drop=BERT_PLD)
    line, params, probs = options_pair(
        functools.partial(bert_large_engine, config=config,
                          dropout=BERT_DROPOUT, stochastic_mode=True),
        batch, SPARSE_PER_STEP, probe=probe)
    del params
    problems += probs
    line["theta_max_abs_diff"] = max(abs(d - h) for d, h in line["probes"])
    if line["theta_max_abs_diff"] > 1e-6:
        problems.append("device pld_theta departs from the host schedule")
    # the eager engine's gates (the last STEPS entries of its module)
    eager = [g for m, g in gates if m == gates[-1][0]][-STEPS:]
    dropped = [int((~g).sum()) for g in eager]
    n_layer = len(eager[0])
    expect = var = 0.0
    for theta, _ in line["probes"]:
        for i in range(n_layer):
            p = float(pld_keep_probability(i, n_layer, theta))
            expect += 1 - p
            var += p * (1 - p)
    line["dropped_layers_by_step"] = dropped
    line["dropped_layers_expected"] = expect
    if abs(sum(dropped) - expect) > KEEP_SIGMAS * _m.sqrt(var) + 0.5:
        problems.append(f"PLD dropped {sum(dropped)} layers, expected "
                        f"{expect}")
    # 12 steps near theta 1 drop ~0.4 layers, which no bound can tell from
    # a gate that never drops: the gates are counted on a small BERT
    free_cuda()
    line["keep_counts"] = pld_keep_counts("bert")
    problems += keep_count_problems(line["keep_counts"])
    line["tokens_per_s"] = SPARSE_SEQ / line["step_ms_median"] * 1e3
    emit({"phase": "bert_options", "part": "progressive_layer_drop",
          "pld": BERT_PLD, "dropout": BERT_DROPOUT, **line})
    free_cuda()
    return line, problems


def bert_dense():
    """A dense BERT-Large at [8, 512] with dropout 0.1 (the einsum path with
    probability dropout; B4 alone): captured against eager."""
    config = dict(BERT_SPARSE_CONFIG,
                  train_micro_batch_size_per_gpu=BERT_DENSE_MICRO)
    del config["sparse_attention"]
    line, params, problems = options_pair(
        functools.partial(bert_large_engine, config=config,
                          dropout=BERT_DROPOUT,
                          max_position_embeddings=BERT_DENSE_SEQ),
        mlm_batch(BERT_DENSE_MICRO, BERT_DENSE_SEQ, seed=2),
        BERT_DENSE_PER_STEP)
    del params
    line["tokens_per_s"] = (BERT_DENSE_MICRO * BERT_DENSE_SEQ
                            / line["step_ms_median"] * 1e3)
    emit({"phase": "bert_options", "part": "dense",
          "batch": [BERT_DENSE_MICRO, BERT_DENSE_SEQ],
          "dropout": BERT_DROPOUT, **line})
    free_cuda()
    return line, problems


# embedding tables whose backward must repeat bit for bit, eager and
# captured: BERT's token types ([1, 4096] of type 0: one id 4096 times),
# its word table over the MLM batch's ids, and the same ids with 490 of
# the positions on one id (a [MASK] token's share of a 15%-masked row).
# What ``bert.TypeEmbed``'s note rests on
EMBED_REPEAT_CASES = (("token_type", 2, "zeros"), ("word", 30522, "mlm"),
                      ("word_one_id_490", 30522, "mlm_490"))


def embedding_backward_repeats():
    """The port's ``VocabEmbed`` (bf16 compute, f32 table, BERT-Large's
    width) on each of ``EMBED_REPEAT_CASES``: its table gradient from one
    upstream gradient, three times eagerly and three captured replays,
    all bit for bit equal; and the captured backward's ms."""
    import torch

    from deepspeed_tpu_torch.models.bert import bert_config
    from deepspeed_tpu_torch.models.transformer_lm import VocabEmbed

    cfg = bert_config("bert-large", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(5)
    mlm = torch.as_tensor(mlm_batch(1, SPARSE_SEQ, seed=3)["input_ids"],
                          device="cuda")
    out = {}
    for name, rows, kind in EMBED_REPEAT_CASES:
        ids = torch.zeros_like(mlm) if kind == "zeros" else mlm.clone()
        if kind == "mlm_490":
            ids[0, torch.randperm(SPARSE_SEQ, generator=gen,
                                  device="cuda")[:490]] = 103
        table = VocabEmbed(rows, cfg.hidden_size, cfg).cuda()
        g = torch.randn(*ids.shape, cfg.hidden_size, generator=gen,
                        device="cuda").to(torch.bfloat16)

        def grad():
            return torch.autograd.grad(table(ids), table.weight, g)[0]

        eager = [grad() for _ in range(3)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            grad()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = grad()
        replays = []
        for _ in range(3):
            graph.replay()
            replays.append(static.clone())
        out[name] = {"rows": rows, "distinct_ids": int(ids.unique().numel()),
                     "identical": all(torch.equal(eager[0], x)
                                      for x in eager[1:] + replays),
                     "captured_ms": device_ms(graph.replay)["ms"]}
        del graph, static, eager, replays, table
    free_cuda()
    return out


def phase_bert_options():
    """BERT breadth (ROADMAP A.7) on the card (see the module docstring).
    Returns the launch counts by path: each run's counts set to 0 just
    before its captured steps and read just after."""
    import torch

    t0 = time.perf_counter()
    problems = []
    batch = mlm_batch(1, SPARSE_SEQ)
    lines, probs = bert_policies(batch)
    problems += probs
    paths = {f"bert_{p}": line["launches"] for p, line in lines.items()}
    checks, probs = bert_dropout_checks(batch, lines["full"])
    problems += probs
    line, probs = bert_pld(batch)
    problems += probs
    paths["bert_pld"] = line["launches"]
    line, probs = bert_dense()
    problems += probs
    paths["bert_dense"] = line["launches"]
    repeats = embedding_backward_repeats()
    if not all(r["identical"] for r in repeats.values()):
        problems.append(f"embedding backward does not repeat: {repeats}")
    emit({"phase": "bert_options", "part": "summary",
          "model": "bert-large", "batch": [1, SPARSE_SEQ],
          "sparse_attention": BIGBIRD_BLOCK, "dropout": BERT_DROPOUT,
          "step_ms_median_by_policy": {
              p: line["step_ms_median"] for p, line in lines.items()},
          "activation_gb_by_policy": {
              p: line["eager_peak_above_state_gb"]
              for p, line in lines.items()},
          "checks": checks, "embedding_backward_repeats": repeats,
          "seconds": time.perf_counter() - t0,
          "problems": problems, "smi": nvidia_smi_line(),
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    if problems:
        raise AssertionError(f"bert_options: {problems}")
    return paths


# Serving breadth (ROADMAP A.8): int8 weights, the int8 KV cache, the
# engine's entry points as CUDA graphs, the continuous-batching scheduler
# with the prefix cache and speculative decoding. Mistral-7B-v0.1 at all 32
# layers and its published widths under the sparse_gpt phase's window
# (SPARSE_GPT_BLOCK, n_positions 32768) with one slack block, int8 weights
# and KV, served through the scheduler; GPT-2 1.3B (dense cache) for the
# graphs against eager and for speculative decoding with a GPT-2
# 125M-shaped draft
SERVING_SLOTS = 8
SERVING_BUCKET = 128
SERVING_REQUESTS = 24
SERVING_PREFIX = 1024
SERVING_PROMPTS = (64, 3000)
SERVING_NEW = (16, 48)
# submitted from a stream callback while run() is going
SERVING_LATE = 4
# the shared-prefix prompts' lengths are 1024 + 37 + 128 j: one pad offset
# in the bucket, so their padded prefixes are the same cache
SERVING_PREFIX_PHASE = 37
SPEC_K = 4
SPEC_REQUESTS = 16
SPEC_PROMPTS = (32, 600)
SPEC_NEW = 32
GPT2_DRAFT = "gpt2-125m"
TTFT_BUCKETS = (128, 256, 512, 1024)
# near-ties: two paths of different GEMM shapes round each layer's bf16
# activations differently, at most one bf16 ulp (2^-8 relative) per layer,
# independent across layers: the logits part by about sqrt(L) 2^-8 of
# their RMS. Two logits part by sqrt(2) of that, and a greedy pick may flip
# where the reference's top-1 minus top-2 gap is under GAP_SIGMAS times
# it. A part above the bound fails the run
GAP_SIGMAS = 4.0


def gap_bound(logits, n_layer):
    """The gap under which two paths' greedy picks may part at one position
    (``GAP_SIGMAS`` sqrt(2) sqrt(L) 2^-8 times the logits' RMS)."""
    rms = float(logits.float().pow(2).mean().sqrt())
    return GAP_SIGMAS * math.sqrt(2.0 * n_layer) * 2.0 ** -8 * rms


def padded_prompt(prompt, bucket, device, pad=None):
    """``prompt`` left-padded to its bucket (or by ``pad`` columns): ids and
    mask ``[1, Lp]``."""
    import torch

    Lp = (-(-len(prompt) // bucket) * bucket if pad is None
          else len(prompt) + pad)
    ids = torch.zeros((1, Lp), dtype=torch.long)
    mask = torch.zeros((1, Lp), dtype=torch.bool)
    ids[0, Lp - len(prompt):] = torch.tensor(prompt)
    mask[0, Lp - len(prompt):] = True
    return ids.to(device), mask.to(device)


def next_logits(engine, prompt, bucket, pad=None):
    """The logits after ``prompt`` by an uncaptured prefill at its bucket,
    or left-padded by ``pad`` columns (the reference's logits at a
    position where two streams part, in the streams' own context)."""
    ids, mask = padded_prompt(prompt, bucket, engine.device, pad)
    logits, _ = engine._chunked_prefill(ids, mask, eager=True)
    return logits[0]


def token_parts(engine, prompts, got, want, bucket, eos=None, pads=None):
    """Each pair of streams (``got`` against the reference ``want``): equal,
    or parting at a near-tie. Returns the parts (request, position, the
    reference's top-1 minus top-2 gap there, the bound) and the problems:
    a part above its bound, or streams of other lengths that do not part.
    ``pads``: each prompt's left pad in the streams (a batch of prompts
    padded to one width; default: its bucket's), where a window layout's
    blocks fall depends on it."""
    n_layer = engine.module.config.n_layer
    parts, problems = [], []
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        if eos is not None and eos[i] is not None and eos[i] in w:
            w = w[:w.index(eos[i]) + 1]
        j = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            if len(g) != len(w):
                problems.append(f"request {i}: {len(g)} tokens, want "
                                f"{len(w)}")
            continue
        logits = next_logits(engine, list(p) + list(w[:j]), bucket,
                             None if pads is None else pads[i])
        top = logits.float().topk(2).values
        gap = float(top[0] - top[1])
        bound = gap_bound(logits, n_layer)
        parts.append({"request": i, "position": j, "gap": gap,
                      "bound": bound})
        if gap > bound:
            problems.append(f"request {i} parts at {j} with gap {gap} > "
                            f"bound {bound}")
    return parts, problems


def serve_requests(sched, requests, late=0):
    """Submit ``requests`` (prompt, max_new_tokens, eos) to ``sched``, the
    last ``late`` of them from the first completions' stream callbacks
    while ``run`` is going; run; return the tokens in request order and
    the stats. Over a serving group every rank calls it: rank 0 numbers
    the requests from its next id in this order (the late ones in order
    too), and its completions reach every rank."""
    pending = list(range(len(requests) - late, len(requests)))
    base = sched.decide(sched._next_id)
    ids = {base + i: i for i in range(len(requests))}

    def submit(i, cb=None):
        prompt, new, eos = requests[i]
        rid = sched.submit(prompt, max_new_tokens=new, eos_token_id=eos,
                           stream_callback=cb)
        if rid is not None:
            ids[rid] = i

    def on_token(rid, token, done):
        if done and pending:
            submit(pending.pop(0))

    for i in range(len(requests) - late):
        submit(i, on_token)
    stats = sched.run()
    if pending and sched.leader:
        raise AssertionError(f"{len(pending)} late requests never submitted")
    out = [None] * len(requests)
    for c in stats.completions:
        out[ids[c.request_id]] = c.tokens
    return out, stats


def serving_requests(vocab, seed=0):
    """``SERVING_REQUESTS`` prompts from ``seed``: half of them the shared
    ``SERVING_PREFIX``-token prefix and a suffix (one pad offset), half of
    64-3000 random tokens; max_new_tokens 16-48."""
    import numpy as np

    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, SERVING_PREFIX).tolist()
    out = []
    for i in range(SERVING_REQUESTS):
        if i % 2 == 0:
            j = rng.randint(1, 16)
            n = SERVING_PREFIX_PHASE + SERVING_BUCKET * j
            prompt = prefix + rng.randint(0, vocab, n).tolist()
        else:
            prompt = rng.randint(0, vocab,
                                 rng.randint(*SERVING_PROMPTS)).tolist()
        out.append((prompt, int(rng.randint(SERVING_NEW[0],
                                            SERVING_NEW[1] + 1))))
    return out


def decode_step_ms(engine, reps=20):
    """One ``[slots, 1]`` greedy decode step of the lanes' graph, fenced,
    median of ``reps`` after two uncounted calls, and one traced step (the
    card's time by kernel)."""
    import torch

    entry = engine._decoder(SERVING_SLOTS)
    tok = torch.zeros(SERVING_SLOTS, dtype=torch.long, device=engine.device)

    def step():
        engine._decode_run(entry.decode, entry.cache, tok, 1, False)

    step()    # the warm-up call (the capture is wall_ms's first)
    return wall_ms(step, reps=reps), _trace(step)[0]


def serving_mistral():
    """Mistral-7B with int8 weights and KV through the scheduler: the
    requests' solo ``generate`` (the reference), then the scheduler with a
    prefix cache (graphs), the first wave through the graphs and through
    the eager twin (bit for bit: tokens and the lanes' cache), the
    shared-prefix requests without the prefix cache (hits against cold
    admissions); resident bytes, decode ms per step int8 against bf16
    weights."""
    import dataclasses

    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.scheduler import \
        ContinuousBatchingScheduler
    from deepspeed_tpu_torch.models.transformer_lm import kv_cache
    from deepspeed_tpu_torch.serving import PrefixCache, PrefixCacheConfig

    problems = []
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    # decode runs of at most 8 steps: fewer run lengths to warm up and
    # capture for the solo references (the scheduler decodes one step)
    engine = init_inference(sparse_gpt_model(kv_cache_slack_blocks=1),
                            dtype="int8",
                            config={"kv_cache": "int8", "decode_chunk": 8},
                            seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    weights_gb = (torch.cuda.memory_allocated() - before) / 1e9
    cfg = engine.module.config
    reqs = serving_requests(cfg.vocab_size)
    prompts = [p for p, _ in reqs]
    bucket = SERVING_BUCKET

    # the reference: each request alone through generate, at its bucket
    t1 = time.perf_counter()
    solo = []
    for prompt, new in reqs:
        ids, mask = padded_prompt(prompt, bucket, engine.device)
        solo.append(engine.generate(ids, max_new_tokens=new,
                                    attention_mask=mask)[0].tolist())
    solo_s = time.perf_counter() - t1
    # an EOS on every third request: its solo token halfway
    eos = [solo[i][len(solo[i]) // 2] if i % 3 == 0 else None
           for i in range(len(reqs))]
    requests = [(p, n, e) for (p, n), e in zip(reqs, eos)]

    # the lanes' cache: its bytes against the allocator's
    m0 = torch.cuda.memory_allocated()
    lanes = engine._decoder(SERVING_SLOTS).cache
    lanes_alloc = torch.cuda.memory_allocated() - m0
    m0 = torch.cuda.memory_allocated()
    bf16_lanes = kv_cache(dataclasses.replace(cfg, kv_cache_dtype=None),
                          SERVING_SLOTS, engine.device)
    bf16_alloc = torch.cuda.memory_allocated() - m0
    del bf16_lanes

    def scheduler(prefix=True, eager=False):
        pc = (PrefixCache(PrefixCacheConfig(align=bucket))
              if prefix else None)
        sched = ContinuousBatchingScheduler(
            engine, slots=SERVING_SLOTS, prompt_bucket=bucket,
            prefix_cache=pc)
        sched.eager = eager
        return sched

    sched = scheduler()
    reset_launches()
    torch.cuda.synchronize()
    got, stats = serve_requests(sched, requests, late=SERVING_LATE)
    torch.cuda.synchronize()
    launches = read_launches()
    summary = stats.summary()
    prefix_stats = sched.prefix_cache.stats()
    kv = sched.kv_cache_stats()
    parts, probs = token_parts(engine, prompts, got, solo, bucket, eos)
    problems += probs

    # the graphs against their eager twin: the first wave (one request per
    # lane, nothing queued behind it) served twice, bit for bit in the
    # tokens and in the lanes' whole cache after
    wave = requests[:SERVING_SLOTS]
    twin_got = []
    for eager in (False, True):
        toks, _ = serve_requests(scheduler(eager=eager), wave)
        twin_got.append((toks, lanes.clone()))
    twin_same = twin_got[0][0] == twin_got[1][0] and all(
        torch.equal(a, b) for a, b in zip(twin_got[0][1].tensors(),
                                          twin_got[1][1].tensors()))
    twin_tokens_as_main = twin_got[0][0] == got[:SERVING_SLOTS]
    del twin_got
    if not twin_same:
        problems.append("the scheduler's graphs and its eager twin differ")
    # prefix-cache hits against cold admissions: the shared-prefix requests
    # again, without the prefix cache
    hit = [i for i in range(len(reqs)) if i % 2 == 0]
    cold_got, cold_stats = serve_requests(scheduler(prefix=False),
                                          [requests[i] for i in hit])
    cold_parts, probs = token_parts(
        engine, [prompts[i] for i in hit], [got[i] for i in hit], cold_got,
        bucket)
    problems += probs
    if prefix_stats["hits"] < len(hit) - 2:
        problems.append(f"prefix cache: {prefix_stats}")
    if launches["flash_attention_fwd"] or launches["block_sparse_fwd"]:
        problems.append(f"the cache path launched a kernel: {launches}")
    # the allocator rounds each tensor up and may keep a block's remainder
    # under 1 MiB unsplit: allocated = resident + at most 1 MiB a tensor
    n_tensors = len(lanes.tensors())
    for name, want, alloc in (("resident_bytes", kv["resident_bytes"],
                               lanes_alloc),
                              ("unquantized_bytes", kv["unquantized_bytes"],
                               bf16_alloc)):
        if not 0 <= alloc - want <= n_tensors << 20:
            problems.append(f"{name} {want} against {alloc} allocated")
    if kv["resident_bytes"] != lanes.nbytes():
        problems.append(f"resident_bytes {kv['resident_bytes']} against "
                        f"the lanes' {lanes.nbytes()}")
    finite = all(len(t) >= 1 and all(0 <= x < cfg.vocab_size for x in t)
                 for t in got)
    if not finite:
        problems.append("tokens out of the vocabulary")
    int8_step_ms, int8_trace = decode_step_ms(engine)
    disagg, probs = serving_disagg(engine, prompts[:DISAGG_REQUESTS])
    problems += probs
    emit(disagg)
    del engine, sched, lanes
    free_cuda()
    # the same weights in bf16 (the dense twin's draw), the KV cache int8
    bf16 = init_inference(sparse_gpt_model(kv_cache_slack_blocks=1),
                          dtype="bf16", config={"kv_cache": "int8"},
                          seed=0)
    bf16_step_ms, bf16_trace = decode_step_ms(bf16)
    del bf16
    free_cuda()
    line = {"phase": "serving", "part": "mistral",
            "model": "mistral-7b-v0.1", "source": MISTRAL_SOURCE,
            "config": dict(MISTRAL_7B, n_positions=SPARSE_GPT_POSITIONS,
                           kv_cache_slack_blocks=1),
            "sparse_attention": SPARSE_GPT_BLOCK, "reduced": {},
            "dtype": "int8", "kv_cache": "int8", "init_s": init_s,
            "weights_gb": weights_gb, "init_peak_gb": init_peak_gb,
            "slots": SERVING_SLOTS, "prompt_bucket": bucket,
            "requests": len(reqs), "late_requests": SERVING_LATE,
            "prompt_lengths": [len(p) for p in prompts],
            "max_new_tokens": [n for _, n in reqs],
            "eos_requests": [i for i, e in enumerate(eos) if e is not None],
            "solo_generate_s": solo_s, "summary": summary,
            "cold_summary": cold_stats.summary(),
            "tokens_per_s": summary["aggregate_tokens_per_s"],
            "launches": launches, "prefix_cache": prefix_stats,
            "kv_cache_stats": kv, "lanes_allocated_bytes": lanes_alloc,
            "bf16_lanes_allocated_bytes": bf16_alloc,
            "scheduler_vs_solo_parts": parts,
            "prefix_hits_vs_cold_parts": cold_parts,
            "graphs_vs_eager_twin_identical": twin_same,
            "twin_wave_tokens_as_in_the_full_run": twin_tokens_as_main,
            "decode_step_ms_8_lanes": {"int8_weights": int8_step_ms,
                                       "bf16_weights": bf16_step_ms},
            "decode_step_trace": {"int8_weights": int8_trace,
                                  "bf16_weights": bf16_trace},
            "gap_sigmas": GAP_SIGMAS,
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(line)
    if problems:
        raise AssertionError(f"serving mistral: {problems}")
    return launches, line


def gpt2_serving_engine(name="gpt2-1.3b", dtype="bf16", seed=0, kv=None):
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer_lm import GPT, gpt2_config

    return init_inference(GPT(gpt2_config(name, use_flash_attention=True)),
                          dtype=dtype, seed=seed,
                          config={"kv_cache": kv} if kv else None)


def timed_pair(graph, eager, reps=5):
    """Median fenced ms of ``graph`` and of ``eager``, in turns."""
    import torch

    g, e = [], []
    graph()
    eager()
    for _ in range(reps):
        for fn, out in ((graph, g), (eager, e)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(g), statistics.median(e)


def serving_gpt2():
    """GPT-2 1.3B: the forward graph against eager forward at [4, 1024]
    (bit for bit, B1 24 per forward), the prefill graphs against eager
    prefill per bucket (logits and cache bit for bit; TTFT), speculative
    decoding with a 125M-shaped draft and with a self-draft against the
    scheduler without one; int8 against bf16 decode at 125M and 1.3B."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.scheduler import \
        ContinuousBatchingScheduler
    from deepspeed_tpu_torch.telemetry import telemetry_bus

    problems = []
    free_cuda()
    engine = gpt2_serving_engine()
    cfg = engine.module.config
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (4, 1024), generator=gen).cuda()
    with torch.inference_mode():
        eager = engine.forward(ids, eager=True)
        calls = [engine(ids) for _ in range(2)]    # warm-up, capture
        reset_launches()
        calls.append(engine(ids))                  # a replay
        torch.cuda.synchronize()
        forward_launches = read_launches()
    forward_same = [bool(torch.equal(c, eager)) for c in calls]
    del calls, eager
    fwd_ms, fwd_eager_ms = timed_pair(lambda: engine(ids),
                                      lambda: engine.forward(ids, eager=True))
    if not all(forward_same):
        problems.append(f"forward graph against eager: {forward_same}")
    if forward_launches["flash_attention_fwd"] != cfg.n_layer:
        problems.append(f"forward graph launched B1 "
                        f"{forward_launches['flash_attention_fwd']} times")

    prefill = {}
    for L in TTFT_BUCKETS:
        p_ids = torch.randint(0, cfg.vocab_size, (1, L),
                              generator=gen).cuda()
        mask = torch.ones_like(p_ids, dtype=torch.bool)
        want, cache = engine._chunked_prefill(p_ids, mask, eager=True)
        want_cache = cache.clone()
        same = []
        for _ in range(3):    # warm-up, capture, replay
            got, cache = engine._chunked_prefill(p_ids, mask)
            same.append(bool(torch.equal(got, want)) and all(
                torch.equal(a, b) for a, b in zip(cache.tensors(),
                                                  want_cache.tensors())))
        # time to the first token on the host: the prefill and its argmax
        g_ms, e_ms = timed_pair(
            lambda: int(engine._chunked_prefill(p_ids, mask)[0].argmax()),
            lambda: int(engine._chunked_prefill(p_ids, mask,
                                                eager=True)[0].argmax()))
        prefill[L] = {"identical": same, "ttft_ms": g_ms,
                      "eager_ttft_ms": e_ms}
        if not all(same):
            problems.append(f"prefill graph at {L} against eager: {same}")
        del want_cache

    # speculative decoding: a 125M-shaped draft (random weights: nearly
    # every proposal is rejected), and the target's own weights as the
    # draft (every proposal accepted); both against no draft
    rng = np.random.RandomState(2)
    requests = [(rng.randint(0, cfg.vocab_size,
                             rng.randint(*SPEC_PROMPTS)).tolist(),
                 SPEC_NEW, None) for _ in range(SPEC_REQUESTS)]
    prompts = [p for p, _, _ in requests]

    def spec_run(draft):
        sched = ContinuousBatchingScheduler(
            engine, slots=SERVING_SLOTS, prompt_bucket=64,
            draft_engine=draft, spec_k=SPEC_K if draft is not None else 0)
        events = []
        telemetry_bus.subscribe(events.append)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, stats = serve_requests(sched, requests)
        torch.cuda.synchronize()
        telemetry_bus.unsubscribe(events.append)
        accepts = [e for e in events if e["kind"] == "serve.spec_accept"]
        if draft is not None and (
                len(accepts) != stats.decode_steps or
                sum(e["accepted"] for e in accepts) != sched.spec_accepted):
            problems.append(f"serve.spec_accept: {len(accepts)} events for "
                            f"{stats.decode_steps} spec steps")
        out = {"wall_s": time.perf_counter() - t0,
               "decode_steps": stats.decode_steps,
               "tokens_per_s": stats.summary()["aggregate_tokens_per_s"]}
        if draft is not None:
            out.update(proposed=sched.spec_proposed,
                       accepted=sched.spec_accepted,
                       accept_rate=sched.spec_accepted / sched.spec_proposed,
                       spec_accept_events=len(accepts))
        return toks, out

    base, base_line = spec_run(None)
    spec = {"none": base_line}
    for name, draft in (("gpt2-125m", lambda: gpt2_serving_engine(
            GPT2_DRAFT, seed=5)), ("self", lambda: gpt2_serving_engine())):
        d = draft()
        toks, spec[name] = spec_run(d)
        del d
        free_cuda()
        parts, probs = token_parts(engine, prompts, toks, base, 64)
        spec[name]["parts_vs_no_draft"] = parts
        problems += probs
    del engine
    free_cuda()

    # int8 against bf16 decode (the int8 warning's numbers); at 1.3B also
    # each KV cache dtype under each weights dtype
    decode = {}
    for name, dtype, kv in (("gpt2-125m", "bf16", None),
                            ("gpt2-125m", "int8", None),
                            ("gpt2-1.3b", "bf16", None),
                            ("gpt2-1.3b", "int8", None),
                            ("gpt2-1.3b", "bf16", "int8"),
                            ("gpt2-1.3b", "int8", "int8")):
        eng = gpt2_serving_engine(name, dtype, kv=kv)
        row = {}
        for b in (1, SERVING_SLOTS):
            prompt = torch.randint(0, 50257, (b, 128), generator=gen).cuda()
            # a run length's first call is its warm-up and the next its
            # capture: time replays only
            one = wall_ms(lambda: eng.generate(prompt, max_new_tokens=1),
                          reps=3)
            eng.generate(prompt, max_new_tokens=33)
            many = wall_ms(lambda: eng.generate(prompt, max_new_tokens=33),
                           reps=3)
            row[f"batch_{b}_ms_per_token"] = (many - one) / 32
        decode[f"{name}_{dtype}_kv_{kv or 'bf16'}"] = row
        del eng
        free_cuda()
    line = {"phase": "serving", "part": "gpt2", "model": "gpt2-1.3b",
            "dtype": "bf16", "forward_shape": [4, 1024],
            "forward_graph_vs_eager_identical": forward_same,
            "forward_launches_per_replay": forward_launches,
            "forward_ms": fwd_ms, "eager_forward_ms": fwd_eager_ms,
            "prefill_by_bucket": prefill, "spec_k": SPEC_K,
            "spec_requests": SPEC_REQUESTS, "spec": spec,
            "int8_vs_bf16_decode": decode}
    emit(line)
    if problems:
        raise AssertionError(f"serving gpt2: {problems}")
    return forward_launches, line


def phase_serving():
    """Serving breadth (ROADMAP A.8): Mistral-7B through the scheduler,
    then GPT-2 1.3B's graphs and speculative decoding. Returns the launch
    counts of the scheduler run and of one forward graph replay."""
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    scheduler, _ = serving_mistral()
    t_mistral = time.perf_counter() - t0
    forward, _ = serving_gpt2()
    emit({"phase": "serving", "part": "done", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0, "mistral_seconds": t_mistral})
    return {"serving_scheduler": scheduler, "serving_forward": forward}


# The serving front door (ROADMAP A.8, second half): ``build_serving``, a
# fleet of replica processes with exact failover, SLO admission under a
# burst, graceful drain. GPT-2 1.3B at its published widths and all 24
# layers, bf16, dense cache. Its n_positions is 1024, so prompts run to
# 960 tokens: the bucketed prompt and 32 new tokens must fit
FRONTDOOR_MODEL = "gpt2-1.3b"
# the replicas' and the parent's engine (``replica_engine``)
FRONTDOOR_SPEC = {"gpt2": FRONTDOOR_MODEL, "dtype": "bf16", "seed": 0}
FRONTDOOR_SERVING = {"slots": 4, "prompt_bucket": 64, "max_pending": 64,
                     "prefix_cache": {"promote_after": 2},
                     "admission": {"slo_ttft_p95_s": 30.0},
                     "journal": True}
FRONTDOOR_REQUESTS = 24
FRONTDOOR_PREFIX = 512
# the shared-prefix prompts' lengths are 512 + 21 + 64 j: one pad offset in
# the bucket, so their padded prefixes are the same cache
FRONTDOOR_PREFIX_PHASE = 21
FRONTDOOR_PROMPTS = (64, 960)
FRONTDOOR_NEW = 32
FRONTDOOR_REPLICAS = 3
FRONTDOOR_KILL_AFTER = 6
# the burst's controller: 4 samples make a p95, and a sample older than
# BURST_AGE_S no longer counts, so a pause of that length lets it recover
BURST_ADMISSION = {"window": 8, "min_samples": 4}
BURST_AGE_S = 1.0
DRAIN_REQUESTS = 12
# silence never marks a replica down here: a death is the pipe's EOF
FLEET_HEALTH = {"suspect_after_s": 60.0, "down_after_s": 600.0}
# a fleet run that goes on past this raises (a hang: a death is an EOF)
FLEET_RUN_LIMIT_S = 300.0
# disaggregated prefill on the serving phase's Mistral-7B int8 engine
DISAGG_REQUESTS = 12
DISAGG_NEW = 16


def replica_engine(spec):
    """The engine of a replica (and of the parent's reference) from
    ``spec``: ``{"gpt2": name}`` (random weights from ``seed`` drawn on the
    engine's device) or ``{"gpt": GPTConfig fields with the dtype by name,
    "sparse_attention": a block or None, "state_dict": {name: numpy
    array}}``; with ``dtype``, ``seed``, ``device`` (None: the card)."""
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer_lm import (GPT, GPTConfig,
                                                           gpt2_config)
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils \
        import apply_sparse_attention

    if "gpt2" in spec:
        model = GPT(gpt2_config(spec["gpt2"], use_flash_attention=True))
    else:
        fields = dict(spec["gpt"])
        fields["dtype"] = getattr(torch, fields["dtype"])
        model = GPT(GPTConfig(**fields))
    if spec.get("sparse_attention"):
        model = apply_sparse_attention(model, spec["sparse_attention"])
    sd = spec.get("state_dict")
    if sd is not None:
        sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    return init_inference(model, dtype=spec.get("dtype", "bf16"),
                          seed=spec.get("seed", 0),
                          device=spec.get("device"), state_dict=sd)


def replica_main(conn, spec, serving):
    """One scheduler replica process (JAX ``examples/serve_router.py``
    ``replica_main``): ``build_serving(replica_engine(spec), serving)``,
    serving what the front door streams in until ("quit",) or the pipe dies.

    Protocol, parent -> child: ("submit", rid, prompt, max_new, replay or
    None), ("reset",) (a fresh scheduler on the same engine, the launch
    counts to 0), ("stats",), ("quit",); child -> parent: ("hello", pid,
    info) once the engine is built, ("tok", rid, token, done) per delivered
    token, ("shed", rid, reason), ("idle", pending) when ``run`` has drained
    its queue, ("ready",) after a reset, ("stats", launches). The pipe is
    pumped between decode steps (``run(poll_fn=...)``), so a failover replay
    lands in a free lane while this replica decodes its own work."""
    # a process group of its own (setsid): the parent kills the child's
    # whole group, never its own
    os.setsid()
    t0 = time.perf_counter()
    import torch

    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    from deepspeed_tpu_torch.runtime import compiled_step
    from deepspeed_tpu_torch.serving import AdmissionRejected, build_serving

    t_import = time.perf_counter() - t0
    engine = replica_engine(spec)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    t_build = time.perf_counter() - t0 - t_import
    state = {"quit": False, "reset": False,
             "sched": build_serving(engine, dict(serving))}
    compiled_step.reset_launch_counts()

    def handle(msg):
        if msg[0] == "submit":
            _, rid, prompt, max_new, replay = msg

            def cb(_local_rid, token, done, _rid=rid):
                conn.send(("tok", _rid, int(token), bool(done)))

            try:
                state["sched"].submit(prompt, max_new_tokens=max_new,
                                      stream_callback=cb,
                                      replay_tokens=replay)
            except AdmissionRejected as e:
                conn.send(("shed", rid, e.reason))
        elif msg[0] == "stats":
            conn.send(("stats", compiled_step.launch_counts()))
        elif msg[0] == "reset":
            state["reset"] = True    # served once run() has returned
        elif msg[0] == "quit":
            state["quit"] = True

    def pump():
        while conn.poll(0):
            handle(conn.recv())

    conn.send(("hello", os.getpid(), {"import_s": t_import,
                                      "build_s": t_build}))
    try:
        while not state["quit"]:
            handle(conn.recv())
            while not state["quit"]:
                if state["reset"]:
                    state["reset"] = False
                    state["sched"] = build_serving(engine, dict(serving))
                    compiled_step.reset_launch_counts()
                    conn.send(("ready",))
                elif state["sched"]._pending:
                    state["sched"].run(poll_fn=pump)
                    conn.send(("idle", len(state["sched"]._pending)))
                else:
                    break
    except (EOFError, OSError):
        pass    # the front door died: nothing left to serve
    conn.close()


def p95(xs):
    """The p95 of ``xs`` (None entries left out) as the scheduler's
    ``summary`` takes it, or None."""
    xs = sorted(x for x in xs if x is not None)
    if not xs:
        return None
    return xs[min(len(xs) - 1, int(0.95 * len(xs)))]


class ReplicaFleet:
    """``n`` replica processes (``replica_main``) behind a
    ``FleetCoordinator`` (JAX ``examples/serve_router.py`` ``run_fleet``).

    The children start with the spawn method (the parent may hold a CUDA
    context, which a forked child cannot use) and each calls ``os.setsid``.
    A child's death shows as EOF on its pipe, never as a timeout: the parent
    closes its copy of each child's end. ``close`` asks the live children
    to quit, then kills and reaps every child's process group, so no orphan
    keeps the card's memory; call it in a ``finally``."""

    def __init__(self, spec, n, serving):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n = int(n)
        self.serving = dict(serving)
        self.conns, self.procs = [], []
        self.alive = [True] * self.n
        self.t_start = time.perf_counter()
        try:
            for _ in range(self.n):
                parent_c, child_c = ctx.Pipe()
                p = ctx.Process(target=replica_main,
                                args=(child_c, spec, self.serving),
                                daemon=True)
                p.start()
                # the parent's copy of the child's end would keep the pipe
                # open after the child dies: no EOF
                child_c.close()
                self.conns.append(parent_c)
                self.procs.append(p)
        except BaseException:
            self.close()
            raise

    def wait_ready(self, limit_s=FLEET_RUN_LIMIT_S):
        """Each child's hello: its import and build seconds, and the seconds
        from the fleet's start to its hello (an EOF if a child died)."""
        out = []
        limit = time.monotonic() + limit_s
        for c in self.conns:
            if not c.poll(max(0.0, limit - time.monotonic())):
                raise AssertionError(f"no hello within {limit_s} s")
            msg = c.recv()
            if msg[0] != "hello":
                raise AssertionError(f"replica said {msg!r} before hello")
            out.append(dict(msg[2], ready_s=time.perf_counter() -
                            self.t_start))
        return out

    def _ask(self, i, msg, answer):
        """Send ``msg`` to replica ``i`` and read until ``answer``."""
        self.conns[i].send(msg)
        while True:
            got = self.conns[i].recv()
            if got[0] == answer:
                return got

    def launches(self):
        """Each live replica's launch counts since its last reset (None for
        a dead one)."""
        return [self._ask(i, ("stats",), "stats")[1] if self.alive[i]
                else None for i in range(self.n)]

    def reset(self):
        """A fresh scheduler (prefix cache, admission, journal) in every
        live replica, over its engine and its graphs."""
        for i in range(self.n):
            if self.alive[i]:
                self._ask(i, ("reset",), "ready")

    def serve(self, prompts, max_new, kill=None, kill_after=6, align=64,
              limit_s=FLEET_RUN_LIMIT_S):
        """Place every prompt through a fresh coordinator (hash-affine over
        the live replicas) and pump the pipes until every request is done.
        ``kill`` (a replica or "auto": the one holding the most requests)
        is SIGKILLed once it has delivered ``kill_after`` tokens; its
        in-flight requests are replayed on survivors. Returns the delivered
        tokens, per-request TTFT, the migrated requests with their replay
        seconds (from the death to the first new token) and the stats."""
        from multiprocessing import connection as mpc

        from deepspeed_tpu_torch.serving import (FleetCoordinator,
                                                 FleetHealth, HealthConfig,
                                                 PrefixRouter)

        if not all(self.alive):
            raise AssertionError("a fleet run starts with every replica up")
        router = PrefixRouter(self.n, align=align, spill_slack=2)
        coord = FleetCoordinator(router, health=FleetHealth(
            self.n, HealthConfig(**FLEET_HEALTH)))
        for i in range(self.n):
            coord.health.heartbeat(i)
        t0 = time.perf_counter()
        placements = []
        for rid, prompt in enumerate(prompts):
            r, how = coord.place(rid, list(prompt), max_new)
            self.conns[r].send(("submit", rid, list(prompt), max_new, None))
            placements.append(r)
        if kill == "auto":
            kill = max(range(self.n), key=placements.count)
        killed = t_dead = None
        tokens_from = [0] * self.n
        moved, replay_s, sheds = {}, {}, []
        limit = time.monotonic() + limit_s
        while coord.journal.stats()["inflight"] > 0:
            if time.monotonic() > limit:
                raise AssertionError(
                    f"fleet run past {limit_s} s: "
                    f"{coord.journal.stats()}")
            live = [c for i, c in enumerate(self.conns) if self.alive[i]]
            if not live:
                raise AssertionError("every replica died with work left")
            for c in mpc.wait(live, timeout=1.0):
                i = self.conns.index(c)
                try:
                    msg = c.recv()
                except (EOFError, OSError):
                    # recv hands over what the child wrote before it died,
                    # so every delivered token is journaled: the replay
                    # starts from exactly the delivered prefix
                    self.alive[i] = False
                    t_dead = time.perf_counter()
                    for rid, target, spec in coord.replica_dead(i, "eof"):
                        self.conns[target].send(
                            ("submit", rid, spec["prompt"],
                             spec["max_new_tokens"], spec["replay_tokens"]))
                        moved[rid] = {"from": i, "to": target,
                                      "emitted": len(spec["replay_tokens"])}
                    continue
                coord.health.heartbeat(i)
                if msg[0] == "tok":
                    _, rid, token, done = msg
                    coord.on_token(rid, token, done=done)
                    tokens_from[i] += 1
                    if rid in moved and rid not in replay_s:
                        replay_s[rid] = time.perf_counter() - t_dead
                    if (killed is None and kill == i
                            and tokens_from[i] >= kill_after):
                        killed = i
                        os.killpg(self.procs[i].pid, signal.SIGKILL)
                elif msg[0] == "shed":
                    coord.journal.record_shed(msg[1])
                    sheds.append(msg[1:])
        wall_s = time.perf_counter() - t0
        entries = [coord.journal.entry(rid) for rid in range(len(prompts))]
        for rid, m in moved.items():
            m["replay_s"] = replay_s.get(rid)
        return {
            "tokens": [list(e.emitted) for e in entries],
            "ttft_s": [None if e.t_first_token is None
                       else e.t_first_token - e.t_submit for e in entries],
            "lost": [rid for rid, e in enumerate(entries)
                     if not e.done or e.shed
                     or len(e.emitted) != e.max_new_tokens],
            "placements": placements, "killed": killed, "migrated": moved,
            "sheds": sheds, "wall_s": wall_s, "router": router.stats(),
            "journal": coord.journal.stats(),
            "health_transitions": [(i, a, b) for _, i, a, b in
                                   coord.health.transitions],
        }

    def close(self):
        for i, c in enumerate(self.conns):
            if self.alive[i]:
                try:
                    c.send(("quit",))
                except (BrokenPipeError, OSError):
                    pass
        for p in self.procs:
            p.join(timeout=20)
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            p.join(timeout=20)
        for c in self.conns:
            c.close()
        self.alive = [False] * self.n


def frontdoor_requests(vocab, seed=0):
    """``FRONTDOOR_REQUESTS`` prompts from ``seed``: the even ones the
    shared ``FRONTDOOR_PREFIX``-token prefix and a suffix (one pad offset),
    the odd ones 64-960 random tokens."""
    import numpy as np

    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, FRONTDOOR_PREFIX).tolist()
    out = []
    for i in range(FRONTDOOR_REQUESTS):
        if i % 2 == 0:
            n = FRONTDOOR_PREFIX_PHASE + 64 * rng.randint(0, 7)
            out.append(prefix + rng.randint(0, vocab, n).tolist())
        else:
            out.append(rng.randint(0, vocab, rng.randint(
                FRONTDOOR_PROMPTS[0], FRONTDOOR_PROMPTS[1] + 1)).tolist())
    return out


def serve_prompts(sched, prompts, new, on_token=None):
    """Submit ``prompts`` (``on_token(i, rid, token, done)`` as each one's
    stream callback when given), run, and return the tokens by prompt, the
    TTFTs and the stats."""
    # over a serving group the other ranks' submits return None: rank 0
    # numbers the prompts from its next id
    base = sched.decide(sched._next_id)
    ids = {}
    for i, p in enumerate(prompts):
        cb = None if on_token is None else functools.partial(on_token, i)
        rid = sched.submit(p, max_new_tokens=new, stream_callback=cb)
        ids[base + i if rid is None else rid] = i
    stats = sched.run()
    toks, ttft = [None] * len(prompts), [None] * len(prompts)
    for c in stats.completions:
        toks[ids[c.request_id]] = c.tokens
        ttft[ids[c.request_id]] = c.ttft_s
    return toks, ttft, stats


def frontdoor_parent(engine, prompts, problems, schedulers):
    """The parent's front-door runs on ``engine``: the reference trace
    through ``build_serving`` against a hand-built scheduler (bit for bit),
    the burst without and with admission, graceful drain. Appends every
    scheduler and its runs' stats to ``schedulers``; returns the reference
    tokens and the parts' lines."""
    import torch

    from deepspeed_tpu_torch.serving import (
        AdmissionConfig, ContinuousBatchingScheduler, DrainingError,
        GracefulDrain, PrefixCache, PrefixCacheConfig, RequestJournal,
        RequestShedError, SLOAdmissionController, build_serving)
    from deepspeed_tpu_torch.telemetry import telemetry_bus

    cfg = FRONTDOOR_SERVING
    bucket = cfg["prompt_bucket"]
    new = FRONTDOOR_NEW
    out = {}

    def check(name, idx, got, want):
        parts, probs = token_parts(engine, [prompts[i] for i in idx], got,
                                   [want[i] for i in idx], bucket)
        problems.extend(f"{name}: {p}" for p in probs)
        out[f"{name}_parts"] = parts

    # the reference trace through build_serving, and through a scheduler
    # built by hand from the same parts: bit for bit
    t0 = time.perf_counter()
    sched = build_serving(engine, dict(cfg))
    want, ttft, stats = serve_prompts(sched, prompts, new)
    schedulers.append((sched, [stats]))
    out["reference_s"] = time.perf_counter() - t0
    out["reference_summary"] = stats.summary()
    parts = {"prefix_align": sched.prefix_cache.config.align,
             "slo": sched.admission_controller.config.slo_ttft_p95_s,
             "journal": type(sched.journal).__name__,
             "max_pending": sched.max_pending}
    if parts != {"prefix_align": bucket, "slo": 30.0,
                 "journal": "RequestJournal", "max_pending": 64}:
        problems.append(f"build_serving's parts: {parts}")
    hand = ContinuousBatchingScheduler(
        engine, slots=cfg["slots"], prompt_bucket=bucket,
        max_pending=cfg["max_pending"],
        prefix_cache=PrefixCache(PrefixCacheConfig(promote_after=2,
                                                   align=bucket)),
        admission_controller=SLOAdmissionController(
            AdmissionConfig(slo_ttft_p95_s=30.0)),
        journal=RequestJournal())
    t0 = time.perf_counter()
    hand_got, _, hand_stats = serve_prompts(hand, prompts, new)
    schedulers.append((hand, [hand_stats]))
    out["hand_built_s"] = time.perf_counter() - t0
    out["build_serving_vs_hand_built_identical"] = hand_got == want
    if hand_got != want:
        problems.append("build_serving and the hand-built scheduler differ")
    try:
        build_serving(engine, dict(cfg, prefix_cahce=True))
        problems.append("build_serving took an unknown key")
    except ValueError as e:
        out["unknown_key_error"] = str(e)

    # the burst: the first wave (one request per lane), and from the 4th
    # first token's callback the other 20 at once. Without admission (all
    # queue: the SLO comes from this run's first wave), then with it
    first = list(range(cfg["slots"]))
    rest = list(range(cfg["slots"], len(prompts)))

    def burst(sched):
        """The first wave, then ``rest`` from the callback of the wave's
        last first token; each submit's (request, admitted, shedding)."""
        toks, ttfts, ids = {}, {}, {}
        rejected, firsts, decisions = [], [], []

        def submit(i, cb):
            try:
                ids[sched.submit(prompts[i], max_new_tokens=new,
                                 stream_callback=cb)] = i
            except RequestShedError:
                rejected.append(i)
            shedding = sched.admission_controller is not None and \
                sched.admission_controller.stats()["shedding"]
            decisions.append((i, i not in rejected, shedding))

        def on_token(rid, token, done):
            if len(firsts) < len(first) and rid not in firsts:
                firsts.append(rid)
                if len(firsts) == len(first):
                    for i in rest:
                        submit(i, None)

        for i in first:
            submit(i, on_token)
        stats = sched.run()
        for c in stats.completions:
            toks[ids[c.request_id]] = c.tokens
            ttfts[ids[c.request_id]] = c.ttft_s
        return toks, ttfts, rejected, decisions, stats

    no_adm = build_serving(engine, {k: v for k, v in cfg.items()
                                    if k != "admission"})
    toks, ttfts, _, _, stats = burst(no_adm)
    schedulers.append((no_adm, [stats]))
    check("burst_without_admission", sorted(toks),
          [toks[i] for i in sorted(toks)], want)
    slo = 0.5 * p95([ttfts[i] for i in first])
    out["burst_without_admission"] = {
        "admitted": len(toks), "ttft_p95_s": p95(ttfts.values()),
        "first_wave_ttft_p95_s": p95([ttfts[i] for i in first])}
    events = []
    telemetry_bus.subscribe(events.append)
    callbacks = []
    adm = build_serving(engine, dict(cfg, admission=dict(
        BURST_ADMISSION, slo_ttft_p95_s=slo, sample_max_age_s=BURST_AGE_S)),
        reject_callback=lambda rid, reason: callbacks.append(reason))
    toks, ttfts, rejected, decisions, stats = burst(adm)
    entered = any(s for _, _, s in decisions)
    # the retries after a pause in which the window's samples age out
    time.sleep(BURST_AGE_S * 1.2)
    retry_ids, retry_decisions = {}, []
    for i in rejected:
        try:
            retry_ids[adm.submit(prompts[i], max_new_tokens=new)] = i
        except RequestShedError:
            retry_decisions.append((i, False))
            continue
        retry_decisions.append(
            (i, adm.admission_controller.stats()["shedding"]))
    retry_stats = adm.run()
    schedulers.append((adm, [stats, retry_stats]))
    telemetry_bus.unsubscribe(events.append)
    left = entered and retry_decisions and not any(
        s for _, s in retry_decisions) and len(retry_ids) == len(rejected)
    for c in retry_stats.completions:
        toks[retry_ids[c.request_id]] = c.tokens
    check("burst_with_admission", sorted(toks),
          [toks[i] for i in sorted(toks)], want)
    sheds = sum(1 for e in events if e["kind"] == "serve.shed")
    out["burst_with_admission"] = {
        "slo_ttft_p95_s": slo, "admitted_first": len(ttfts),
        "shed": len(rejected), "shed_events": sheds,
        "reject_callbacks": len(callbacks), "entered_shedding": entered,
        "left_shedding": bool(left), "decisions": decisions,
        "retries_admitted": len(retry_ids),
        "ttft_p95_s": p95(ttfts.values()),
        "controller": adm.admission_controller.stats()}
    if not (entered and left):
        problems.append(f"admission did not enter and leave shedding: "
                        f"{decisions} then {retry_decisions}")
    if not len(rejected) == sheds == len(callbacks) > 0:
        problems.append(f"sheds: {len(rejected)} errors, {sheds} events, "
                        f"{len(callbacks)} callbacks")
    if len(toks) != len(prompts):
        problems.append(f"burst: {len(toks)} of {len(prompts)} served")
    adm.admission_controller.close()

    # graceful drain: SIGTERM from a stream callback; admission closes, the
    # lanes finish, the queue is handed off and served by a fresh scheduler
    drain_sched = build_serving(engine, dict(cfg))
    drain = GracefulDrain(drain_sched)
    uninstall = drain.install()
    after_term = []
    idx = list(range(DRAIN_REQUESTS))
    try:
        def on_token(i, rid, token, done):
            if i == 0 and not after_term and \
                    len(drain_sched.journal.entry(rid).emitted) == 3:
                os.kill(os.getpid(), signal.SIGTERM)
                try:
                    drain_sched.submit(prompts[0], max_new_tokens=new)
                    after_term.append("admitted")
                except DrainingError as e:
                    after_term.append(e.reason)

        got, _, stats = serve_prompts(drain_sched, [prompts[i] for i in idx],
                                      new, on_token)
    finally:
        uninstall()
    specs = drain.complete()
    done = [i for i in idx if got[i] is not None]
    fresh = build_serving(engine, dict(cfg))
    rids = [fresh.submit(s["prompt"], max_new_tokens=s["max_new_tokens"],
                         replay_tokens=s["replay_tokens"]) for s in specs]
    fresh_stats = fresh.run()
    by_rid = {c.request_id: c.tokens for c in fresh_stats.completions}
    handed = [prompts.index(s["prompt"]) for s in specs]
    for i, rid in zip(handed, rids):
        got[i] = by_rid.get(rid)
    schedulers.append((drain_sched, [stats]))
    schedulers.append((fresh, [fresh_stats]))
    check("drain", idx, [got[i] for i in idx], want)
    out["drain"] = {"after_sigterm": after_term, "lanes_finished": done,
                    "handed_off": handed, "draining": drain_sched.draining,
                    "drain_reason": drain_sched.drain_reason}
    if after_term != ["draining"] or len(done) != cfg["slots"] or \
            sorted(done + handed) != idx or not drain.drained:
        problems.append(f"drain: {out['drain']}")
    torch.cuda.synchronize()
    return want, ttft, out


def phase_frontdoor():
    """The serving front door (ROADMAP A.8) on GPT-2 1.3B: ``build_serving``
    and the parent's runs (``frontdoor_parent``) while FRONTDOOR_REPLICAS
    replica processes build their engines, then the fleet: a warm-up run,
    the baseline, and the chaos run that SIGKILLs the most-loaded replica
    after FRONTDOOR_KILL_AFTER delivered tokens. Returns the launch counts
    of the parent's runs (the cache path: no kernel)."""
    import torch

    from deepspeed_tpu_torch.telemetry import telemetry_bus

    problems = []
    t_phase = time.perf_counter()
    free_cuda()
    spec = FRONTDOOR_SPEC
    timeline = {}
    fleet = ReplicaFleet(spec, FRONTDOOR_REPLICAS, FRONTDOOR_SERVING)
    try:
        t0 = time.perf_counter()
        engine = replica_engine(spec)
        torch.cuda.synchronize()
        timeline["parent_init_s"] = time.perf_counter() - t0
        # the weights a replica would take from shared tensors: the load
        # alone, without the transport (a lower bound for sharing)
        sd = {k: v.clone() for k, v in engine.module.state_dict().items()}
        t0 = time.perf_counter()
        twin = replica_engine(dict(spec, state_dict=sd))
        torch.cuda.synchronize()
        timeline["state_dict_init_s"] = time.perf_counter() - t0
        del twin, sd
        free_cuda()
        prompts = frontdoor_requests(engine.module.config.vocab_size)
        counts0 = telemetry_bus.counts()
        schedulers = []
        reset_launches()
        t0 = time.perf_counter()
        want, ref_ttft, parent = frontdoor_parent(engine, prompts, problems,
                                                  schedulers)
        parent_launches = read_launches()
        timeline["parent_runs_s"] = time.perf_counter() - t0
        counts = telemetry_bus.counts()
        delta = {k: counts.get(k, 0) - counts0.get(k, 0)
                 for k in set(counts) | set(counts0)}
        admits = sum(len(s.completions) for _, runs in schedulers
                     for s in runs)
        shed = sum(sch.shed_count for sch, _ in schedulers)
        bus = {"serve.admit": (delta.get("serve.admit", 0), admits),
               "serve.first_token": (delta.get("serve.first_token", 0),
                                     admits),
               "serve.shed+deadline_shed": (
                   delta.get("serve.shed", 0)
                   + delta.get("serve.deadline_shed", 0), shed),
               "serve.drain": (delta.get("serve.drain", 0), 2)}
        for k, (events, counters) in bus.items():
            if events != counters:
                problems.append(f"bus {k}: {events} events against "
                                f"{counters} from the counters")

        t0 = time.perf_counter()
        hello = fleet.wait_ready()
        timeline["wait_for_replicas_s"] = time.perf_counter() - t0
        runs = {}
        events = []
        for name in ("warm", "baseline", "chaos"):
            if name != "warm":
                fleet.reset()
            if name == "chaos":
                telemetry_bus.subscribe(events.append)
            run = fleet.serve(prompts, FRONTDOOR_NEW,
                              kill="auto" if name == "chaos" else None,
                              kill_after=FRONTDOOR_KILL_AFTER,
                              align=FRONTDOOR_SERVING["prompt_bucket"])
            if name == "chaos":
                telemetry_bus.unsubscribe(events.append)
            run["launches"] = fleet.launches()
            timeline[f"fleet_{name}_s"] = run["wall_s"]
            parts, probs = token_parts(engine, prompts, run["tokens"], want,
                                       FRONTDOOR_SERVING["prompt_bucket"])
            problems.extend(f"fleet {name}: {p}" for p in probs)
            run["parts"] = parts
            if run["lost"]:
                problems.append(f"fleet {name} lost {run['lost']}")
            runs[name] = run
        chaos = runs["chaos"]
        migrated = sorted(chaos["migrated"])
        fo = sorted(e["request_id"] for e in events
                    if e["kind"] == "serve.failover")
        downs = [e["replica"] for e in events
                 if e["kind"] == "serve.replica_down"]
        if chaos["killed"] is None or not migrated:
            problems.append(f"chaos: killed {chaos['killed']}, migrated "
                            f"{migrated}")
        if fo != migrated:
            problems.append(f"serve.failover {fo} against migrated "
                            f"{migrated}")
        if downs != [chaos["killed"]]:
            problems.append(f"serve.replica_down {downs}, killed "
                            f"{chaos['killed']}")
        for name, run in runs.items():
            for i, counts in enumerate(run["launches"]):
                if counts is not None and any(counts.values()):
                    problems.append(f"fleet {name}: replica {i} launched "
                                    f"{counts}")
    finally:
        fleet.close()
    if any(parent_launches.values()):
        problems.append(f"the parent's cache path launched {parent_launches}")
    ttft = chaos["ttft_s"]
    result = {
        "phase": "frontdoor", "model": FRONTDOOR_MODEL, "dtype": "bf16",
        "reduced": {}, "serving": FRONTDOOR_SERVING,
        "requests": len(prompts), "max_new_tokens": FRONTDOOR_NEW,
        "prompt_lengths": [len(p) for p in prompts],
        "replicas": FRONTDOOR_REPLICAS, "replica_start": hello,
        "timeline": timeline, "parent": parent, "bus_vs_counters": bus,
        "parent_launches": parent_launches,
        "fleet": {name: {k: run[k] for k in (
            "killed", "migrated", "lost", "wall_s", "router", "journal",
            "parts", "placements", "health_transitions")}
            for name, run in runs.items()},
        "ttft_p95_s": {
            "reference_in_process": p95(ref_ttft),
            "fleet_warm_up": p95(runs["warm"]["ttft_s"]),
            "baseline_no_kill": p95(runs["baseline"]["ttft_s"]),
            "chaos_with_failover": p95(ttft),
            "chaos_migrated_only": p95(ttft[r] for r in migrated),
            "no_failover_counterfactual": p95(
                v for r, v in enumerate(ttft) if r not in migrated)},
        "no_failover_lost_requests": len(migrated),
        "failover_events": len(fo), "replica_down_events": downs,
        "near_tie_parts": {name: len(run["parts"])
                           for name, run in runs.items()},
        "gap_sigmas": GAP_SIGMAS, "problems": problems,
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "seconds": time.perf_counter() - t_phase}
    emit(result)
    del engine
    free_cuda()
    if problems:
        raise AssertionError(f"frontdoor: {problems}")
    return {"frontdoor": parent_launches}


def serving_disagg(engine, prompts):
    """Disaggregated prefill on the serving phase's engine:
    ``DisaggServer(scheduler, [PrefillWorker(engine)])`` with every prompt
    submitted before ``run`` (each hand-off owns a copy of the batch-1
    cache, which the next prefill overwrites), against the co-located
    scheduler on the same requests: tokens bit for bit, one
    ``serve.kv_transfer`` per request, each hand-off's bytes
    ``lane_kv_bytes``' resident bytes, with its seconds (prefill and copy;
    the copy alone timed beside them). Returns the line and its
    problems."""
    import dataclasses

    import torch

    from deepspeed_tpu_torch.inference.scheduler import \
        ContinuousBatchingScheduler
    from deepspeed_tpu_torch.models.transformer_lm import GPT
    from deepspeed_tpu_torch.serving import (ROLE_DECODE, ROLE_PREFILL,
                                             DisaggServer, FleetCoordinator,
                                             PrefillWorker, PrefixRouter,
                                             lane_kv_bytes)
    from deepspeed_tpu_torch.telemetry import telemetry_bus

    problems = []
    t0 = time.perf_counter()

    def scheduler():
        return ContinuousBatchingScheduler(engine, slots=SERVING_SLOTS,
                                           prompt_bucket=SERVING_BUCKET)

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want, _, _ = serve_prompts(scheduler(), prompts, DISAGG_NEW)
    torch.cuda.synchronize()
    colocated_s = time.perf_counter() - t1
    events = []
    telemetry_bus.subscribe(events.append)
    try:
        # a coordinator with one prefill and one decode replica: it
        # accounts each hand-off with its seconds (prefill and copy)
        server = DisaggServer(scheduler(), [PrefillWorker(
            engine, prompt_bucket=SERVING_BUCKET, replica=0)],
            coordinator=FleetCoordinator(PrefixRouter(2), roles=[
                ROLE_PREFILL, ROLE_DECODE]))
        t1 = time.perf_counter()
        # a hand-off's id is rank 0's on every rank of a serving group
        rids = [server.submit(p, max_new_tokens=DISAGG_NEW)
                for p in prompts]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        stats = server.run()
        torch.cuda.synchronize()
        disagg_s = time.perf_counter() - t1
    finally:
        telemetry_bus.unsubscribe(events.append)
    by_rid = {c.request_id: c.tokens for c in stats.completions}
    got = [by_rid.get(r) for r in rids]
    transfers = [e for e in events if e["kind"] == "serve.kv_transfer"]
    lane = lane_kv_bytes(engine.module)
    bf16 = lane_kv_bytes(GPT(dataclasses.replace(engine.module.config,
                                                 kv_cache_dtype=None),
                             parallel=engine.module.parallel))
    # the hand-off copy: one batch-1 cache, device to device
    cache = engine._decoder(1).cache
    copy_ms = wall_ms(lambda: cache.clone())
    # what the port keeps once per row (flax: valid and index per layer)
    bookkeeping = sum(t.numel() * t.element_size() for t in (
        cache.valid, cache.index, cache.position,
        getattr(cache, "slot_pos", None)) if t is not None)
    if got != want:
        problems.append("disaggregated tokens differ from the co-located "
                        "scheduler's")
    # only rank 0 of a serving group publishes; each rank hands off its
    # own KV heads
    leader = server.scheduler.leader
    if leader and [e["request_id"] for e in transfers] != rids:
        problems.append(f"serve.kv_transfer for {len(transfers)} of "
                        f"{len(rids)} requests")
    sizes = sorted({e["bytes"] for e in transfers})
    if (leader and sizes != [lane["resident_bytes"]]) or \
            server.handoff_bytes != len(prompts) * lane["resident_bytes"]:
        problems.append(f"hand-off bytes {sizes} ({server.handoff_bytes} "
                        f"in all) against lane_kv_bytes {lane}")
    line = {"phase": "serving", "part": "disagg", "requests": len(prompts),
            "max_new_tokens": DISAGG_NEW, "identical_to_colocated":
            got == want, "kv_transfer_events": len(transfers),
            "handoff_bytes": sizes,
            "handoff_bytes_this_rank": server.handoff_bytes,
            "lane_kv_bytes": lane,
            "lane_kv_bytes_bf16": bf16,
            "bf16_over_int8": bf16["resident_bytes"] / lane["resident_bytes"],
            "port_bookkeeping_bytes": bookkeeping,
            "kv_and_scale_bytes": lane["resident_bytes"] - bookkeeping,
            "transfer_s": [e.get("transfer_s") for e in transfers],
            "handoff_copy_ms": copy_ms,
            "handoff_copy_gb_per_s": lane["resident_bytes"] / copy_ms / 1e6,
            "colocated_s": colocated_s, "prefill_all_s": prefill_s,
            "disagg_s": disagg_s, "server": {
                k: v for k, v in server.stats().items() if k != "frontdoor"},
            "seconds": time.perf_counter() - t0, "problems": problems}
    return line, problems


# ---------------------------------------------------------------------------
# parallel (ROADMAP A.9 part 1): the tp and ep mesh axes, one rank per card
# ---------------------------------------------------------------------------
PARALLEL_DIR = os.path.join("build", "chip_smoke_parallel")
PARALLEL_RANK_TIMEOUT_S = 1300
PARALLEL_GROUP_TIMEOUT_S = 600
# the multi-card parts need this many cards (tp 4 and ep 4)
PARALLEL_MIN_WORLD = 4
PARALLEL_TP = 4
PARALLEL_EP = 4
# tp 4 against one card on the same weights: each layer's two row-parallel
# products reach the residual stream as four bf16 partial sums added by
# NCCL in bf16 (one more rounding of 2^-8 relative per element, twice a
# layer), where one card rounds the whole product once. Independent over
# the 64 sums of 32 layers, that adds up in quadrature to sqrt(64) 2^-8 =
# 3.1e-2 of the logits; the bound is twice that. The same bound holds the
# Mixtral runs under ep 4 (the experts' batched products at E/ep experts
# against E: other GEMM shapes, the same bf16 rounding points)
PARALLEL_LOGITS_REL_L2 = 6.4e-2
# the 8-layer tp runs and the 2-layer ep run against one card: the zero
# phase's bounds (within_zero_bounds), on 12 distinct batches, but for the
# first step's grad norm. The zero phase's first step differs from one
# card's only in the exchange; a tp run's forward rounds each row-parallel
# product through bf16 partial sums too, so its first step, from the same
# weights, differs like two forward paths do. On four H100s (80GB HBM3,
# 700 W, one repeated batch) the first step's grad norm lay 5.9e-5 (tp 4),
# 7.0e-5 (tp 2 x dp 2) and 2.7e-5 (Mixtral at ep 4) off; the bound is about
# 3x the largest. (The zero phase's control, a run that lost one rank's
# rows, lay 0.105 off at its first step.) On one batch repeated 12 times the
# runs memorize it (the loss falls from 11.2 to ~1.5) and their late steps
# part far past the zero bounds (losses 0.17-0.30 apart, the ep run's
# routing flips): distinct batches keep the comparison at its rounding
PARALLEL_GNORM_FIRST_REL_TOL = 2.5e-4
# Mixtral at ep 4 against one card, 12 distinct batches: the losses lay
# 8.6e-5 apart, the grad norms 2.4e-5 at the first step and 1.4e-2 at most,
# yet the 12-step update 0.126 (over the zero phase's 0.12): Adam turns the
# rounding of the gradients of leaves that take few tokens into steps of
# +-lr. The line splits the update by expert leaves and the rest; a fault
# that mixed experts or lost a rank's rows moves the first step's grad
# norm and the losses first (the zero phase's control: 0.105 and 7.0e-2
# off, its update 0.74). The update is held against a witness read in the
# same call (the constant below was twice that one reading): the
# one-card engine against itself with the rows of each global micro batch
# reversed, the gating noise reversed with them (each token keeps its
# draw, so the routing is the same and only the order of the sums
# changes), as BERT_WITNESS_FACTOR holds BERT's stage 3. The bound is
# MOE_WITNESS_FACTOR times the witness's update, and never looser than
# PARALLEL_MOE_UPDATE_REL_L2. The ep run only reorders sums as the witness
# does (it read 0.92 of the witness's update on an H100): 1.5 leaves room
# for the spread of the two readings and keeps the witness, not the cap,
# the limit (1.5 x 0.1365 = 0.205 at that reading)
MOE_WITNESS_FACTOR = 1.5
PARALLEL_MOE_UPDATE_REL_L2 = 0.25
PARALLEL_PROMPT_BUCKET = 512
PARALLEL_NEW_TOKENS = 32
# the 32-layer tp 4 training run: captured against eager over this many
# steps (2 warm-ups, the capture, 2 replays); every layer is alike
PARALLEL_FULL_STEPS = 5
PARALLEL_FULL_PER_STEP = {"flash_attention_fwd": 64,
                          "flash_attention_bwd_dq": 32,
                          "flash_attention_bwd_dkv": 32, "fused_adamw": 1}
# a tag saved at tp 4 and served on one card: Mistral's widths at 1 layer
# (0.48 B parameters, ~5 GB of tag with the optimizer's moments)
PARALLEL_TAG_LAYERS = 1
PARALLEL_TAG_STEPS = 2
# Mixtral-8x7B under ep 4: against one card at 16 layers (47 GB there),
# alone at all 32 (~26 GB a rank: a quarter of the experts, all the rest)
PARALLEL_MIXTRAL_CMP_LAYERS = 16
# ep 4 training at 2 layers, one [1, 4096] row per rank, against one card
# at the global micro batch of 4 rows (one draw of the gating noise over
# the global batch, sliced by rank, is what one card draws at micro 4; at
# gas 4 it would draw it micro batch by micro batch, in another order),
# with no token dropped (top-2 capacity 2 x 4 / 8 = the tokens) and the
# load-balancing loss off (each ep rank balances its own rows, as
# reference DeepSpeed; one card the global batch)
PARALLEL_MIXTRAL_TRAIN = dict(moe_capacity_factor=4.0, moe_aux_loss_coef=0.0)
PARALLEL_MIXTRAL_ROWS = 1
PARALLEL_MIXTRAL_PER_STEP = MIXTRAL_PER_STEP
# the world-1 run (a one-card run): the tp path at tp 1 at Mistral's
# widths and the ep path at ep 1 at Mixtral's, in process on one-rank groups
PARALLEL_ONE_CARD_TP_LAYERS = 2
PARALLEL_ONE_CARD_EP_LAYERS = 1
# the scheduler over a tp engine (ROADMAP A.9 part 2a): the serving phase's
# Mistral-7B int8 engine (weights and KV, the window's ring) and its
# 24-request mix at tp 4; at one card the tp path at tp 1, 2 layers, the
# mix's first 16 requests
PARALLEL_SCHED_ONE_CARD_REQUESTS = 16
# the one-card comparisons of the tp-1 path against the path without a
# layout (the window's training, the fused head) run this many distinct
# batches (each path's captured run against eager keeps STEPS)
PARALLEL_ONE_CARD_CMP_STEPS = 4
# build_serving under a burst (the first wave, one request a lane, then the
# rest at once from a stream callback) and DisaggServer: the mix's first 16
# prompts, 16 new tokens each, through 4 lanes (the controller sheds only
# from a queue of a lane count: 12 queue behind the first wave)
PARALLEL_BURST_REQUESTS = 16
PARALLEL_BURST_SLOTS = 4
PARALLEL_BURST_NEW = 16
# an SLO no TTFT meets: the controller sheds every arrival once the queue
# holds a lane count (the first wave's TTFTs set no usable SLO here: the
# run without admission warms the prefill graphs the second run replays)
PARALLEL_BURST_SLO_S = 1e-6
# Mixtral-8x7B through the scheduler at ep 4 (at one card the ep path at ep
# 1, one layer, 4 requests): the mix's first requests against each one's
# solo generate on the same engine
PARALLEL_MIXTRAL_SCHED_REQUESTS = 8
PARALLEL_MIXTRAL_SCHED_ONE_CARD = 4
# Mistral-7B's published window at tp 4: served at 32 layers against one
# card, trained at 8 on [1, 16384] against one card on 12 distinct batches;
# at one card the tp path at tp 1, 2 layers
PARALLEL_WINDOW_SERVE_WIDTH = 47 * 128   # the prompts' block-aligned width
# the fused head + CE over the vocab-parallel head: the 8-layer tp run's
# batches at tp 4; at one card the tp path at tp 1, 2 layers
# the C.6 check: attention-probability dropout at tp 4, 2 layers
PARALLEL_C6_LAYERS = 2
PARALLEL_C6_DROPOUT = 0.1
PARALLEL_C6_PER_STEP = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                        "flash_attention_bwd_dkv": 0, "fused_adamw": 1}


def parallel_tp_engine(tp, layers, stage=1, micro=MISTRAL_MICRO, seed=0,
                       one_card=False, **over):
    """Mistral-7B's widths at ``layers`` through ``initialize`` with
    ``GPT_PRETRAIN_CONFIG`` (full remat) under ``tpu.mesh`` tp, the rest
    dp, ZeRO ``stage``, ``micro`` rows of each global micro batch of 2 a
    rank; ``over``: config fields (the fused head, dropout, a window
    layout). ``one_card``: the group-less engine (built before any
    group)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT
    from deepspeed_tpu_torch.parallel.tensor import ParallelLayout

    config = dict(GPT_PRETRAIN_CONFIG, train_micro_batch_size_per_gpu=micro,
                  zero_optimization={"stage": stage})
    if not one_card:
        config["tpu"] = dict(config["tpu"], mesh={"tp": tp, "dp": -1})
    cfg = mistral_config(n_layer=layers, remat=True, **over)
    # the tp code path at every tp, 1 included
    model = GPT(cfg) if one_card else GPT(cfg, parallel=ParallelLayout())
    return deepspeed_tpu_torch.initialize(model=model, config=config,
                                          seed=seed)[0]


def parallel_ep_engine(ep, layers, micro, seed=0, one_card=False, **over):
    """Mixtral-8x7B's widths at ``layers`` through ``initialize`` (full
    remat) under ``tpu.mesh`` ep, ``micro`` rows a rank."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer_lm import GPT
    from deepspeed_tpu_torch.parallel.tensor import ParallelLayout

    config = dict(GPT_PRETRAIN_CONFIG, train_micro_batch_size_per_gpu=micro)
    if not one_card:
        config["tpu"] = dict(config["tpu"], mesh={"ep": ep, "dp": -1})
    cfg = mixtral_config(n_layer=layers, remat=True, **over)
    model = GPT(cfg) if one_card else GPT(cfg, parallel=ParallelLayout())
    return deepspeed_tpu_torch.initialize(model=model, config=config,
                                          seed=seed)[0]


def parallel_batch(rows, vocab=32000, seed=1):
    import numpy as np

    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(rows, MISTRAL_SEQ)).astype(np.int64)
    return {"input_ids": ids, "labels": ids}


def parallel_path(make, batch, steps, per_step, *, phase, part,
                  problems):
    """``make()``'s engine: ``steps`` captured steps against as many eager
    ones (``captured_against_eager``), the launches per step and the loss.
    Returns the line and the captured run's launches."""
    import numpy as np

    check, launches, losses, norms, times, e_losses, e_times = \
        captured_against_eager(make, [batch], steps)
    ms = statistics.median(times[CAPTURE_WARMUP + 1:])
    line = {"phase": phase, "part": part, "steps": steps, "losses": losses,
            "grad_norms": norms, "eager_losses": e_losses,
            "captured_vs_eager": check, "launches": launches,
            "step_ms_median": ms, "step_ms": times,
            "peak_allocated_gb": check["peak_allocated_gb"]}
    emit(line)
    if not all(np.isfinite(losses)):
        problems.append(f"{part}: non-finite loss")
    if not check["identical"]:
        problems.append(f"{part}: captured and eager steps differ")
    for name, per in {**per_step, **UNSEGMENTED}.items():
        if launches[name] != per * steps:
            problems.append(f"{part}: {name} {launches[name]} launches, "
                            f"want {per} x {steps}")
    return line, launches


def parallel_one_card():
    """The world-1 run: Mistral's widths at 2 layers through the tp code
    path at tp 1 and Mixtral's at 1 layer through the ep path at ep 1
    (each captured against eager, with its launches), in process on a
    one-rank NCCL group; then the same paths under ROADMAP A.9 part 2a,
    each against the path without a layout: the scheduler over the tp-1
    engine (the int8 window engine at 2 layers, the mix's first 16
    requests, with the burst and the disaggregated server) and over the
    ep-1 engine (4 requests against the one-card engine's generate), the
    window's training step through the tp path at tp 1 (2 layers, against
    the one-card window engine), and the fused head + CE through the tp
    path at tp 1 (against the one-card fused head); these two on
    ``PARALLEL_ONE_CARD_CMP_STEPS`` distinct batches. The C.6 masks run at
    four cards. Returns the launches by path."""
    import torch

    from deepspeed_tpu_torch import comm, init_inference
    from deepspeed_tpu_torch.models.transformer_lm import GPT
    from deepspeed_tpu_torch.parallel.tensor import ParallelLayout

    problems = []
    L = PARALLEL_ONE_CARD_TP_LAYERS
    comm.init_distributed()
    try:
        tp_line, tp_launches = parallel_path(
            lambda: parallel_tp_engine(1, L),
            parallel_batch(MISTRAL_MICRO), STEPS,
            {"flash_attention_fwd": 2 * L,
             "flash_attention_bwd_dq": L,
             "flash_attention_bwd_dkv": L,
             "fused_adamw": 1},
            phase="parallel", part="tp1_train", problems=problems)
        free_cuda()
        ep_line, ep_launches = parallel_path(
            lambda: parallel_ep_engine(1, PARALLEL_ONE_CARD_EP_LAYERS, 1),
            parallel_batch(1), STEPS,
            {"flash_attention_fwd": 2 * PARALLEL_ONE_CARD_EP_LAYERS,
             "flash_attention_bwd_dq": PARALLEL_ONE_CARD_EP_LAYERS,
             "flash_attention_bwd_dkv": PARALLEL_ONE_CARD_EP_LAYERS,
             "fused_adamw": 2},
            phase="parallel", part="ep1_train", problems=problems)
        free_cuda()
        t0 = time.perf_counter()
        sched, sched_launches, p = parallel_scheduler(
            0, 1, layers=L, n_requests=PARALLEL_SCHED_ONE_CARD_REQUESTS)
        problems += p
        emit(dict(sched, seconds=time.perf_counter() - t0))
        t0 = time.perf_counter()
        cfg = mixtral_config(n_layer=PARALLEL_ONE_CARD_EP_LAYERS)
        one = init_inference(GPT(cfg), dtype="bf16", seed=0)
        ep1 = init_inference(GPT(cfg, parallel=ParallelLayout()),
                             dtype="bf16", seed=0)
        line, p = scheduler_vs_generate(
            ep1, serving_requests(cfg.vocab_size)[
                :PARALLEL_MIXTRAL_SCHED_ONE_CARD], reference=one)
        problems += [f"ep1 scheduler: {x}" for x in p]
        emit(dict(line, phase="parallel", part="ep1_scheduler",
                  seconds=time.perf_counter() - t0))
        del one, ep1
        free_cuda()
        t0 = time.perf_counter()
        window_ref = one_card_run(
            lambda: parallel_window_engine(1, L, one_card=True),
            window_batches(PARALLEL_ONE_CARD_CMP_STEPS),
            PARALLEL_ONE_CARD_CMP_STEPS)
        window, window_launches, p = parallel_window_train(
            0, 1, L, window_ref, captured=False)
        problems += p
        emit(dict(window, phase="parallel", part="tp1_window",
                  seconds=time.perf_counter() - t0))
        del window_ref
        t0 = time.perf_counter()
        batches = parallel_train_batches(MISTRAL_MICRO, 100)[
            :PARALLEL_ONE_CARD_CMP_STEPS]
        one_run = one_card_run(lambda: parallel_tp_engine(
            1, L, one_card=True, fused_head_ce=True), batches, len(batches))
        fused = tp_run_vs(0, lambda: parallel_tp_engine(
            1, L, fused_head_ce=True), batches, {"one_card": one_run},
            problems, "tp1 fused")
        fused.pop("final", None)
        emit({"phase": "parallel", "part": "tp1_fused_head", "fused": fused,
              "seconds": time.perf_counter() - t0})
        del one_run
    finally:
        free_cuda()
        comm.destroy_distributed()
    del tp_line, ep_line
    torch.cuda.synchronize()
    if problems:
        raise AssertionError(f"parallel (world 1): {problems}")
    return {"parallel_tp_train": tp_launches,
            "parallel_ep_train": ep_launches,
            "parallel_tp_scheduler": sched_launches,
            "parallel_tp_window_train": window_launches}


# -- the multi-card run: one process per card (--parallel-rank) -------------
def parallel_train_references():
    """Rank 0's group-less references, made before the group: Mistral's 8
    layers at micro 2 (``STEPS`` captured steps: losses, grad norms, start
    and final parameters on the host), Mixtral's 2 layers at the global
    micro batch of the ep run and its witness (``mixtral_witness``), the
    window's 8 layers at [1, 16384], and the digests of the dropout masks
    of the C.6 check's first step."""
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    out = {"window": one_card_run(
               lambda: parallel_window_engine(1, MISTRAL_TRAIN_LAYERS,
                                              one_card=True),
               window_batches()),
           "c6_digests": c6_masks(lambda: c6_engine(1, one_card=True),
                                  PARALLEL_TP)}
    for key, make, batches in (
            ("mistral", lambda: parallel_tp_engine(
                1, MISTRAL_TRAIN_LAYERS, one_card=True),
             parallel_train_batches(MISTRAL_MICRO, 100)),
            ("mixtral", lambda: parallel_ep_engine(
                1, MIXTRAL_TRAIN_LAYERS, PARALLEL_EP * PARALLEL_MIXTRAL_ROWS,
                one_card=True, **PARALLEL_MIXTRAL_TRAIN),
             parallel_train_batches(PARALLEL_EP * PARALLEL_MIXTRAL_ROWS,
                                    200))):
        free_cuda()
        eng = make()
        start = {k: v.cpu() for k, v in eng.module.state_dict().items()}
        losses, norms, times = train_steps(
            eng, iter(RepeatingLoader(batches)), STEPS)
        out[key] = {"losses": [float(x) for x in losses],
                    "grad_norms": [float(x) for x in norms],
                    "step_ms": times, "start": start,
                    "final": {k: v.cpu() for k, v in
                              eng.module.state_dict().items()}}
        del eng
        free_cuda()
    ref = out["mixtral"]
    witness = mixtral_witness(parallel_train_batches(
        PARALLEL_EP * PARALLEL_MIXTRAL_ROWS, 200))
    ref["witness"] = {
        "update_rel_l2": update_rel_l2(
            {k: v.cuda() for k, v in witness["final"].items()},
            ref["final"], ref["start"]),
        "loss_rel_err": max(rel_errs(witness["losses"], ref["losses"])),
        "grad_norm_rel_err_by_step": rel_errs(witness["grad_norms"],
                                              ref["grad_norms"])}
    del witness
    free_cuda()
    return out


def parallel_train_batches(rows, seed):
    """``STEPS`` distinct [rows, 4096] batches."""
    return [parallel_batch(rows, seed=seed + i) for i in range(STEPS)]


def parallel_within_bounds(vs):
    """``within_zero_bounds`` with the tp forward's first-step bound."""
    return within_zero_bounds(dict(
        vs, grad_norm_rel_err_by_step=[0.0] + vs[
            "grad_norm_rel_err_by_step"][1:])) and vs[
        "grad_norm_rel_err_by_step"][0] <= PARALLEL_GNORM_FIRST_REL_TOL


def parallel_vs(losses, norms, params, ref):
    """A run against a reference: the zero phase's measures
    (``within_zero_bounds``)."""
    by_step = rel_errs(norms, ref["grad_norms"])
    return {"loss_rel_err": max(rel_errs(losses, ref["losses"])),
            "grad_norm_rel_err": max(by_step),
            "grad_norm_rel_err_by_step": by_step,
            "update_rel_l2": update_rel_l2(params, ref["final"],
                                           ref["start"])}


def parallel_prompts(vocab=32000, seed=3):
    """The 4 ragged prompts (``MISTRAL_PROMPT_LENGTHS``), as lists and as
    one left-padded [4, 512] batch with its mask."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, vocab, size=n).tolist()
               for n in MISTRAL_PROMPT_LENGTHS]
    T = PARALLEL_PROMPT_BUCKET
    ids = torch.zeros((len(prompts), T), dtype=torch.long)
    mask = torch.zeros((len(prompts), T), dtype=torch.bool)
    for i, p in enumerate(prompts):
        ids[i, T - len(p):] = torch.tensor(p)
        mask[i, T - len(p):] = True
    return prompts, ids.cuda(), mask.cuda()


def parallel_serve(rank, world, dtype):
    """Mistral-7B at 32 layers served at tp ``world`` in ``dtype`` against
    the one-card engine (rank 0 builds it) on the same random weights:
    ``forward`` [2, 4096] within ``PARALLEL_LOGITS_REL_L2``, the decode
    graphs against eager decode bit for bit, greedy tokens of 4 ragged
    prompts against the one-card engine's under the near-tie rule, ms per
    decode step of 8 lanes against one card's, B1 launches per forward."""
    import torch

    from deepspeed_tpu_torch import comm, init_inference
    from deepspeed_tpu_torch.models.transformer_lm import GPT

    cfg = mistral_config()
    ids = torch.from_numpy(parallel_batch(2, seed=4)["input_ids"]).cuda()
    prompts, pids, pmask = parallel_prompts()
    out, ref = {"dtype": dtype}, None
    if rank == 0:
        ref = init_inference(GPT(cfg), dtype=dtype, seed=0)
        ref_logits = ref.forward(ids, eager=True)
        ref_tokens = ref.generate(pids, PARALLEL_NEW_TOKENS,
                                  attention_mask=pmask).tolist()
        out["one_card_decode_step_ms"] = decode_step_ms(ref, reps=10)[0]
    comm.barrier()
    eng = init_inference(GPT(cfg), dtype=dtype, mp_size=world, seed=0)
    out["state_gb"] = torch.cuda.memory_allocated() / 1e9
    eng.forward(ids)                              # the warm-up
    reset_launches()
    logits = eng.forward(ids)                     # the captured graph
    out["forward_launches"] = read_launches()
    out["decode_graphs"] = compare_decode(eng, pids, pmask,
                                          n=PARALLEL_NEW_TOKENS)
    tokens = eng.generate(pids, PARALLEL_NEW_TOKENS,
                          attention_mask=pmask).tolist()
    out["decode_step_ms"] = decode_step_ms(eng, reps=10)[0]
    out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if rank == 0:
        out["logits_rel_l2"] = _rel_l2(logits, ref_logits)
        out["logits_finite"] = bool(torch.isfinite(logits).all())
        out["parts"], out["token_problems"] = token_parts(
            ref, prompts, tokens, ref_tokens, PARALLEL_PROMPT_BUCKET)
        out["tokens_equal"] = sum(a == b for a, b in zip(tokens, ref_tokens))
        out["speedup_vs_one_card"] = (out["one_card_decode_step_ms"]
                                      / out["decode_step_ms"])
        del ref_logits
    del eng, ref, logits
    free_cuda()
    comm.barrier()
    return out


def parallel_mistral_train(rank, world, refs, tag_dir):
    """Mistral-7B's widths under tp: 8 layers at tp ``world`` (12 captured
    steps against 12 eager ones, and against the one-card reference within
    the zero bounds), tp 2 x dp 2 at stages 1 and 3 and the fused head + CE
    at tp ``world`` against both (each run's peak a rank), a tag
    saved at tp ``world`` (1 layer) served on one card bit for bit the
    gathered state, and all 32 layers at tp ``world`` captured against
    eager with its launches, step time, TFLOP/s and peak memory."""
    import torch

    from deepspeed_tpu_torch import comm, init_inference
    from deepspeed_tpu_torch.models.transformer_lm import GPT
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    problems, out = [], {}
    batch = parallel_batch(MISTRAL_MICRO)
    batches = parallel_train_batches(MISTRAL_MICRO, 100)
    kept = {}

    def keep(engine):
        params = engine.params                     # gathered: collective
        if rank == 0:
            kept["vs"] = params
        del params

    line, launches = parallel_path(
        lambda: parallel_tp_engine(world, MISTRAL_TRAIN_LAYERS), batch,
        STEPS, MISTRAL_PER_STEP, phase="parallel", part=f"tp{world}_train",
        problems=problems)
    del line
    # the same run again, captured only, for the comparison with the
    # reference (captured_against_eager keeps no parameters)
    # (and the fused head + CE over the vocab-parallel head at tp `world`,
    # against the unfused tp run and one card, with each run's peak)
    runs = {}
    for name, tp, stage, over in ((f"tp{world}", world, 1, {}),
                                  ("tp2_dp2_stage1", 2, 1, {}),
                                  ("tp2_dp2_stage3", 2, 3, {}),
                                  (f"tp{world}_fused_head", world, 1,
                                   {"fused_head_ce": True})):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        dp = world // tp
        eng = parallel_tp_engine(tp, MISTRAL_TRAIN_LAYERS, stage=stage,
                                 micro=MISTRAL_MICRO // dp, **over)
        losses, norms, times = train_steps(
            eng, iter(RepeatingLoader(batches)), STEPS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        keep(eng)
        del eng
        free_cuda()
        if rank == 0:
            params = {k: v.cuda() for k, v in kept.pop("vs").items()}
            run = {"losses": [float(x) for x in losses],
                   "grad_norms": [float(x) for x in norms],
                   "step_ms_median": statistics.median(
                       times[CAPTURE_WARMUP + 1:]),
                   "peak_allocated_gb_per_rank": peak_gb,
                   "vs_one_card": parallel_vs(
                       [float(x) for x in losses], [float(x) for x in norms],
                       params, refs["mistral"])}
            if runs:
                first = runs[f"tp{world}"]
                run["vs_tp"] = parallel_vs(
                    run["losses"], run["grad_norms"], params,
                    {"losses": first["losses"],
                     "grad_norms": first["grad_norms"],
                     "start": refs["mistral"]["start"],
                     "final": first["final"]})
            run["final"] = {k: v.cpu() for k, v in params.items()}
            del params
            runs[name] = run
            for key in ("vs_one_card", "vs_tp"):
                if key in run and not parallel_within_bounds(run[key]):
                    problems.append(f"{name} {key} outside the zero bounds: "
                                    f"{run[key]}")
    if rank == 0:
        out["runs"] = {k: {kk: vv for kk, vv in v.items() if kk != "final"}
                       for k, v in runs.items()}
    runs.clear()
    free_cuda()

    # a tag at tp `world`, served on one card
    eng = parallel_tp_engine(world, PARALLEL_TAG_LAYERS)
    it = iter(RepeatingLoader([batch]))
    for _ in range(PARALLEL_TAG_STEPS):
        eng.train_batch(it)
    t0 = time.perf_counter()
    eng.save_checkpoint(tag_dir)
    out["tag_save_s"] = time.perf_counter() - t0
    whole = eng.params
    del eng
    free_cuda()
    if rank == 0:
        tag = os.path.join(tag_dir, f"global_step{PARALLEL_TAG_STEPS}")
        one = init_inference(GPT(mistral_config(n_layer=PARALLEL_TAG_LAYERS)),
                             dtype="bf16", checkpoint=tag)
        diff = first_difference(whole, one.params)
        ids = torch.from_numpy(batch["input_ids"]).cuda()
        served = bool(torch.isfinite(one.forward(ids)).all())
        out["tag"] = {"served_bit_for_bit": diff is None,
                      "first_difference": diff, "forward_finite": served}
        if diff is not None or not served:
            problems.append(f"the tp tag on one card: {out['tag']}")
        del one
    del whole
    free_cuda()
    comm.barrier()

    # all 32 layers at tp `world`
    torch.cuda.reset_peak_memory_stats()
    full, full_launches = parallel_full_run(world, batch, problems)
    out["full"] = full
    return out, launches, full_launches, problems


def parallel_full_run(world, batch, problems):
    """All 32 layers of Mistral-7B at tp ``world``: ``PARALLEL_FULL_STEPS``
    captured steps against as many eager ones, each rank's shard compared
    (no rank holds the gathered 14.5 GB twice), the loss falling."""
    import torch

    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    steps = PARALLEL_FULL_STEPS
    runs = []
    for eager in (False, True):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        eng = parallel_tp_engine(world, MISTRAL_7B["n_layer"])
        state_gb = torch.cuda.memory_allocated() / 1e9
        losses, norms, times = train_steps(
            eng, iter(RepeatingLoader([batch])), steps, eager=eager)
        launches = read_launches()
        shard = {k: v.clone() for k, v in eng.module.state_dict().items()}
        runs.append({"losses": losses, "norms": norms, "times": times,
                     "launches": launches, "shard": shard,
                     "state_gb": state_gb,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        del eng
        if not eager:
            runs[0]["shard"] = {k: v.cpu() for k, v in shard.items()}
        del shard
    cap, eag = runs
    diff = first_difference({k: v.cuda() for k, v in cap["shard"].items()},
                            eag["shard"])
    identical = (diff is None and identical_floats(cap, eag))
    ms = statistics.median(cap["times"][CAPTURE_WARMUP + 1:])
    tokens = batch["input_ids"].size
    cfg = mistral_config()
    tflops = tokens * gpt_flops_per_token(cfg, MISTRAL_SEQ) / ms / 1e9
    line = {"phase": "parallel", "part": f"tp{world}_train_32_layers",
            "steps": steps, "losses": [float(x) for x in cap["losses"]],
            "eager_losses": [float(x) for x in eag["losses"]],
            "captured_identical_to_eager": identical,
            "first_difference": diff, "launches": cap["launches"],
            "step_ms_median": ms, "step_ms": cap["times"],
            "eager_step_ms_median": statistics.median(
                eag["times"][CAPTURE_WARMUP + 1:]),
            "model_tflops_per_s": tflops,
            "model_tflops_per_s_per_card": tflops / world,
            "state_gb_per_rank": cap["state_gb"],
            "peak_allocated_gb_per_rank": cap["peak_gb"],
            "eager_peak_allocated_gb_per_rank": eag["peak_gb"]}
    emit(line)
    losses = line["losses"]
    if not identical:
        problems.append("32 layers: captured and eager steps differ")
    if not losses[-1] < losses[0]:
        problems.append(f"32 layers: the loss did not fall: {losses}")
    for name, per in {**PARALLEL_FULL_PER_STEP, **UNSEGMENTED}.items():
        if cap["launches"][name] != per * steps:
            problems.append(f"32 layers: {name} {cap['launches'][name]} "
                            f"launches, want {per} x {steps}")
    runs.clear()
    free_cuda()
    return line, cap["launches"]


def identical_floats(a, b):
    """Whether two runs' losses and grad norms are equal bit for bit."""
    return (identical(a["losses"], b["losses"])
            and identical(a["norms"], b["norms"]))


def parallel_mixtral(rank, world, refs):
    """Mixtral-8x7B under ep ``world``: ``forward`` [1, 4096] at 16 layers
    against the one-card engine (rank 0), all 32 layers served (``forward``
    and the decode graphs against eager, and the scheduler against each
    request's solo generate), and 2 layers trained against the one-card
    reference (the update within ``MOE_WITNESS_FACTOR`` of the witness's)."""
    import torch

    from deepspeed_tpu_torch import comm, init_inference
    from deepspeed_tpu_torch.models.transformer_lm import GPT
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    problems, out = [], {}
    ids = torch.from_numpy(parallel_batch(1, seed=5)["input_ids"]).cuda()
    cfg16 = mixtral_config(n_layer=PARALLEL_MIXTRAL_CMP_LAYERS)
    ref_logits = None
    if rank == 0:
        ref = init_inference(GPT(cfg16), dtype="bf16", seed=0)
        ref_logits = ref.forward(ids, eager=True).cpu()
        del ref
        free_cuda()
    comm.barrier()
    eng = init_inference(GPT(cfg16), dtype="bf16", ep_size=world, seed=0)
    logits = eng.forward(ids, eager=True)
    if rank == 0:
        out["cmp_16_layers_logits_rel_l2"] = _rel_l2(logits.cpu(), ref_logits)
        if not out["cmp_16_layers_logits_rel_l2"] <= PARALLEL_LOGITS_REL_L2:
            problems.append(f"Mixtral 16 layers at ep {world} against one "
                            f"card: {out['cmp_16_layers_logits_rel_l2']}")
    del eng, logits, ref_logits
    free_cuda()
    torch.cuda.reset_peak_memory_stats()

    eng = init_inference(GPT(mixtral_config()), dtype="bf16", ep_size=world,
                         seed=0)
    out["serve_32_layers_state_gb_per_rank"] = \
        torch.cuda.memory_allocated() / 1e9
    eng.forward(ids)
    reset_launches()
    logits = eng.forward(ids)
    out["serve_32_layers_forward_launches"] = read_launches()
    out["serve_32_layers_logits_finite"] = bool(torch.isfinite(logits).all())
    _, pids, pmask = parallel_prompts()
    _, _, same = mistral_decode_logits(eng, pids[:2], pmask[:2])
    out["serve_32_layers_decode_graphs_identical"] = same
    out["serve_32_layers_peak_gb_per_rank"] = \
        torch.cuda.max_memory_allocated() / 1e9
    if not (all(same) and out["serve_32_layers_logits_finite"]):
        problems.append(f"Mixtral 32 layers at ep {world}: decode graphs "
                        f"{same}, finite {out['serve_32_layers_logits_finite']}")
    if out["serve_32_layers_forward_launches"]["flash_attention_fwd"] != 32:
        problems.append("Mixtral 32 layers: B1 launches per forward "
                        f"{out['serve_32_layers_forward_launches']}")
    # the scheduler over the ep engine against each request's solo
    # generate on it
    out["scheduler"], p = scheduler_vs_generate(
        eng, serving_requests(MIXTRAL_8X7B["vocab_size"])[
            :PARALLEL_MIXTRAL_SCHED_REQUESTS])
    problems += [f"Mixtral ep scheduler: {x}" for x in p]
    del eng, logits
    free_cuda()
    comm.barrier()

    batches = parallel_train_batches(world * PARALLEL_MIXTRAL_ROWS, 200)
    reset_launches()
    eng = parallel_ep_engine(world, MIXTRAL_TRAIN_LAYERS,
                             PARALLEL_MIXTRAL_ROWS, **PARALLEL_MIXTRAL_TRAIN)
    losses, norms, times = train_steps(
        eng, iter(RepeatingLoader(batches)), STEPS)
    launches = read_launches()
    params = eng.params
    out["train_launches"] = launches
    out["train_step_ms_median"] = statistics.median(
        times[CAPTURE_WARMUP + 1:])
    out["train_peak_gb_per_rank"] = torch.cuda.max_memory_allocated() / 1e9
    for name, per in {**PARALLEL_MIXTRAL_PER_STEP, **UNSEGMENTED}.items():
        if launches[name] != per * STEPS:
            problems.append(f"Mixtral ep train: {name} {launches[name]} "
                            f"launches, want {per} x {STEPS}")
    if rank == 0:
        vs = parallel_vs([float(x) for x in losses],
                         [float(x) for x in norms], params, refs["mixtral"])
        ref = refs["mixtral"]
        for part, keep in (("experts", lambda k: ".experts." in k),
                           ("other", lambda k: ".experts." not in k)):
            vs[f"update_rel_l2_{part}"] = update_rel_l2(
                {k: v for k, v in params.items() if keep(k)}, ref["final"],
                ref["start"])
        witness = ref["witness"]
        bound = min(MOE_WITNESS_FACTOR * witness["update_rel_l2"],
                    PARALLEL_MOE_UPDATE_REL_L2)
        out["train_vs_one_card"] = vs
        out["train_witness"] = dict(witness, update_bound=bound)
        out["train_losses"] = [float(x) for x in losses]
        if not (parallel_within_bounds(dict(vs, update_rel_l2=0.0))
                and vs["update_rel_l2"] <= bound):
            problems.append(f"Mixtral ep train outside the bounds: {vs}, "
                            f"update bound {bound}")
    del eng, params
    free_cuda()
    return out, launches, problems


# -- ROADMAP A.9 part 2a: the scheduler, the window and the fused head
# over the tp and ep paths, and C.6 ------------------------------------------
def window_sparsity():
    """``SPARSE_GPT_BLOCK`` as the config's ``sparse_attention`` (a model
    built with it and a ``ParallelLayout`` keeps its tp path at tp 1, where
    the engine's ``sparse_attention`` block would rebuild it without)."""
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils \
        import get_sparse_attention_config

    return get_sparse_attention_config(dict(SPARSE_GPT_BLOCK),
                                       MISTRAL_7B["n_head"])


def parallel_serving_model(world, **over):
    """Mistral-7B at n_positions 32768 under the window, as one rank's
    shard: at world 1 built with a ``ParallelLayout`` (the tp path at tp
    1), else as a plain model that ``init_inference(mp_size=world)``
    splits."""
    from deepspeed_tpu_torch.models.transformer_lm import GPT
    from deepspeed_tpu_torch.parallel.tensor import ParallelLayout

    cfg = mistral_config(n_positions=SPARSE_GPT_POSITIONS,
                         sparse_attention=window_sparsity(), **over)
    return GPT(cfg, parallel=ParallelLayout()) if world == 1 else GPT(cfg)


def parallel_burst(engine, requests, one, problems):
    """``build_serving`` over ``engine`` under a burst: the first wave (one
    request a lane), then the rest at once from the stream callback of the
    wave's last first token (rank 0's), without admission, then with an SLO
    no request meets (``PARALLEL_BURST_SLO_S``, ``BURST_ADMISSION``), whose
    shed requests are submitted again after a pause. Every request is served or
    shed and then served (none lost), the decisions are rank 0's (the other
    ranks' controllers decide nothing), and on rank 0 the streams hold to
    ``one``'s (the one-card engine's ``want`` streams) under the near-tie
    bound."""
    from deepspeed_tpu_torch.inference.scheduler import RequestShedError
    from deepspeed_tpu_torch.serving import build_serving

    cfg = {"slots": PARALLEL_BURST_SLOTS, "prompt_bucket": SERVING_BUCKET,
           "max_pending": 64}
    first = list(range(PARALLEL_BURST_SLOTS))
    rest = list(range(PARALLEL_BURST_SLOTS, len(requests)))

    def burst(sched):
        toks, ttfts, ids, rejected, firsts = {}, {}, {}, [], []

        def submit(i, cb=None):
            try:
                rid = sched.submit(requests[i][0],
                                   max_new_tokens=PARALLEL_BURST_NEW,
                                   stream_callback=cb)
                ids[rid] = i
            except RequestShedError:
                rejected.append(i)

        def on_token(rid, token, done):
            if rid not in firsts:
                firsts.append(rid)
                if len(firsts) == len(first):
                    for i in rest:
                        submit(i)

        for i in first:
            submit(i, on_token)
        stats = sched.run()
        for c in stats.completions:
            if sched.leader:
                toks[ids[c.request_id]] = c.tokens
                ttfts[ids[c.request_id]] = c.ttft_s
        return toks, ttfts, rejected, stats, ids

    no_adm = build_serving(engine, dict(cfg))
    toks, ttfts, _, stats, _ = burst(no_adm)
    slo = PARALLEL_BURST_SLO_S
    out = {"without_admission": {"served": len(stats.completions),
                                 "ttft_p95_s": p95(ttfts.values())
                                 if ttfts else None}}
    adm = build_serving(engine, dict(cfg, admission=dict(
        BURST_ADMISSION, slo_ttft_p95_s=slo, sample_max_age_s=BURST_AGE_S)))
    toks2, ttfts2, rejected, stats, ids = burst(adm)
    time.sleep(BURST_AGE_S * 1.2)
    retry = {}
    for i in rejected:
        try:
            retry[adm.submit(requests[i][0],
                             max_new_tokens=PARALLEL_BURST_NEW)] = i
        except RequestShedError:
            problems.append(f"burst: request {i} shed again after the pause")
    retry_stats = adm.run()
    controller = adm.admission_controller.stats()
    served = len(stats.completions) + len(retry_stats.completions)
    for c in retry_stats.completions:
        if adm.leader:
            toks2[retry[c.request_id]] = c.tokens
    out["with_admission"] = {
        "slo_ttft_p95_s": slo, "shed": len(rejected), "served": served,
        "ttft_p95_s": p95(ttfts2.values()) if ttfts2 else None,
        "controller": controller}
    adm.admission_controller.close()
    decisions = controller["admit_decisions"] + controller["shed_decisions"]
    n = len(requests)
    if served != n or out["without_admission"]["served"] != n:
        problems.append(f"burst: served {out['without_admission']['served']}"
                        f" without admission and {served} with, of {n}")
    if adm.leader:
        if not rejected:
            problems.append(f"burst: the SLO shed nothing: {controller}")
        for name, got in (("without_admission", toks),
                          ("with_admission", toks2)):
            order = sorted(got)
            parts, probs = token_parts(
                one, [requests[i][0] for i in order],
                [got[i] for i in order],
                [one.want[i][:PARALLEL_BURST_NEW] for i in order],
                SERVING_BUCKET)
            out[name]["parts"] = parts
            problems += [f"burst {name}: {x}" for x in probs]
    elif decisions or rejected:
        problems.append(f"burst: a rank other than 0 decided admission: "
                        f"{controller}, {rejected}")
    return out


def parallel_scheduler(rank, world, layers=None, n_requests=SERVING_REQUESTS):
    """Mistral-7B int8 (weights and KV) under the window's ring (the serving
    phase's engine) at tp ``world`` through the scheduler: the serving
    phase's request mix (seed 0, the last 4 submitted mid-run) against the
    one-card scheduler's streams, run on rank 0 first, under the near-tie
    bound; tokens/s, TTFT and the [8, 1] step against one card; then
    ``build_serving`` over the same engine under a burst and
    ``DisaggServer`` (bit for bit the co-located scheduler, each rank's
    hand-off bytes). At world 1 the tp path at tp 1. Returns the line, the
    scheduler run's launches and the problems."""
    import torch

    from deepspeed_tpu_torch import comm, init_inference
    from deepspeed_tpu_torch.inference.scheduler import \
        ContinuousBatchingScheduler
    from deepspeed_tpu_torch.serving import PrefixCache, PrefixCacheConfig

    over = {"kv_cache_slack_blocks": 1}
    if layers is not None:
        over["n_layer"] = layers
    config = {"kv_cache": "int8", "decode_chunk": 8}
    reqs = serving_requests(MISTRAL_7B["vocab_size"])[:n_requests]
    requests = [(p, n, None) for p, n in reqs]
    prompts = [p for p, _ in reqs]
    late = min(SERVING_LATE, n_requests // 2)
    bucket = SERVING_BUCKET
    problems = []
    out = {"phase": "parallel", "part": f"tp{world}_scheduler",
           "layers": layers or MISTRAL_7B["n_layer"], "tp": world,
           "requests": n_requests, "late_requests": late,
           "dtype": "int8", "kv_cache": "int8", "slots": SERVING_SLOTS}

    def scheduler(engine):
        return ContinuousBatchingScheduler(
            engine, slots=SERVING_SLOTS, prompt_bucket=bucket,
            prefix_cache=PrefixCache(PrefixCacheConfig(align=bucket)))

    one = None
    if rank == 0:
        # the one-card engine: no layout, on rank 0's card beside its shard
        one = init_inference(sparse_gpt_model(**over), dtype="int8",
                             config=config, seed=0)
        one.want, one_stats = serve_requests(scheduler(one), requests,
                                             late=late)
        out["one_card"] = one_stats.summary()
        out["one_card_decode_step_ms"] = decode_step_ms(one)[0]
    comm.barrier()
    t0 = time.perf_counter()
    engine = init_inference(parallel_serving_model(world, **over),
                            dtype="int8", config=config, mp_size=world,
                            seed=0)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    sched = timed_host_syncs(scheduler(engine))
    reset_launches()
    got, stats = serve_requests(sched, requests, late=late)
    torch.cuda.synchronize()
    out["launches"] = launches = read_launches()
    out["summary"] = stats.summary()
    # this rank's host decisions: a stop/drain (with the token digests)
    # each loop iteration, one take each admission, the prefix hits
    out["host_syncs"] = dict(
        sched.host_syncs, ms_per_decode_step=1e3 * sched.host_syncs["s"]
        / max(1, stats.decode_steps), decode_steps=stats.decode_steps)
    out["tokens_per_s"] = out["summary"]["aggregate_tokens_per_s"]
    out["prefix_cache"] = sched.prefix_cache.stats()
    out["kv_cache_stats"] = sched.kv_cache_stats()
    out["decode_step_ms"], out["decode_step_trace"] = decode_step_ms(engine)
    if launches["flash_attention_fwd"] or launches["block_sparse_fwd"]:
        problems.append(f"the cache path launched a kernel: {launches}")
    if rank == 0:
        out["parts"], probs = token_parts(one, prompts, got, one.want, bucket)
        problems += probs
        out["tokens_per_s_one_card"] = out["one_card"][
            "aggregate_tokens_per_s"]
        out["decode_step_speedup"] = (out["one_card_decode_step_ms"]
                                      / out["decode_step_ms"])
    out["burst"] = parallel_burst(
        engine, requests[:PARALLEL_BURST_REQUESTS], one, problems)
    disagg, probs = serving_disagg(engine, prompts[:DISAGG_REQUESTS])
    problems += probs
    out["disagg"] = {k: disagg[k] for k in (
        "identical_to_colocated", "kv_transfer_events", "handoff_bytes",
        "handoff_bytes_this_rank", "lane_kv_bytes", "handoff_copy_ms",
        "disagg_s", "colocated_s")}
    out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del engine, sched, one
    free_cuda()
    comm.barrier()
    return out, launches, problems


def timed_host_syncs(sched):
    """``sched`` with its host decisions over the serving group
    (``decide``, ``_agree``: gloo on the host) counted and their seconds
    summed in ``sched.host_syncs``, waits for the slowest rank
    included."""
    sched.host_syncs = {"calls": 0, "s": 0.0}
    for name in ("decide", "_agree"):
        def timed(*args, _fn=getattr(sched, name)):
            t = time.perf_counter()
            try:
                return _fn(*args)
            finally:
                sched.host_syncs["calls"] += 1
                sched.host_syncs["s"] += time.perf_counter() - t
        setattr(sched, name, timed)
    return sched


def scheduler_vs_generate(engine, reqs, reference=None):
    """The scheduler's streams of ``reqs`` (prompt, new) against each
    request's solo ``generate`` at its bucket on ``reference`` (default
    ``engine`` itself), under the near-tie bound. Every rank of a serving
    group calls it. Returns the line's fields and the problems."""
    from deepspeed_tpu_torch.inference.scheduler import \
        ContinuousBatchingScheduler

    reference = engine if reference is None else reference
    bucket = SERVING_BUCKET
    want = []
    for prompt, new in reqs:
        ids, mask = padded_prompt(prompt, bucket, reference.device)
        want.append(reference.generate(ids, max_new_tokens=new,
                                       attention_mask=mask)[0].tolist())
    sched = ContinuousBatchingScheduler(engine, slots=SERVING_SLOTS,
                                        prompt_bucket=bucket)
    reset_launches()
    got, stats = serve_requests(sched, [(p, n, None) for p, n in reqs])
    launches = read_launches()
    parts, problems = token_parts(reference, [p for p, _ in reqs], got, want,
                                  bucket)
    return {"requests": len(reqs), "summary": stats.summary(),
            "parts": parts, "launches": launches}, problems


def parallel_window_serve(rank, world, layers=None):
    """Mistral-7B's window at tp ``world``, bf16, served against the
    one-card window engine (rank 0) on the same seeded weights: ``forward``
    [1, 16384] on B5 within ``PARALLEL_LOGITS_REL_L2``, greedy streams of 4
    left-padded prompts of 4500-6000 tokens (block-aligned width, 128-token
    prefill spans over the 4224-slot ring) under the near-tie bound, the
    decode graphs against eager decode bit for bit, the ring's bytes a
    rank. Returns the line and the problems."""
    import torch

    from deepspeed_tpu_torch import comm, init_inference

    over = {} if layers is None else {"n_layer": layers}
    n_layer = layers or MISTRAL_7B["n_layer"]
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, MISTRAL_7B["vocab_size"], (1, SPARSE_GPT_SEQ),
                        generator=gen)
    lens = SPARSE_GPT_PROMPT_LENGTHS
    width = PARALLEL_WINDOW_SERVE_WIDTH
    prompt_lists = [torch.randint(0, MISTRAL_7B["vocab_size"], (n,),
                                  generator=gen).tolist() for n in lens]
    prompts = torch.zeros((len(lens), width), dtype=torch.long)
    mask = torch.zeros((len(lens), width), dtype=torch.bool)
    for i, p in enumerate(prompt_lists):
        prompts[i, width - len(p):] = torch.tensor(p)
        mask[i, width - len(p):] = True
    ids, prompts, mask = ids.cuda(), prompts.cuda(), mask.cuda()
    out = {"phase": "parallel", "part": f"tp{world}_window_serve",
           "layers": n_layer, "tp": world, "dtype": "bf16",
           "forward_shape": [1, SPARSE_GPT_SEQ], "prompt_lengths": list(lens),
           "prompt_width": width}
    problems, one, ref_logits, ref_tokens = [], None, None, None
    if rank == 0:
        one = init_inference(sparse_gpt_model(**over), dtype="bf16", seed=0)
        ref_logits = one.forward(ids, eager=True)
        ref_tokens = one.generate(prompts, MISTRAL_NEW_TOKENS,
                                  attention_mask=mask).tolist()
    comm.barrier()
    engine = init_inference(parallel_serving_model(world, **over),
                            dtype="bf16", mp_size=world, seed=0)
    engine.forward(ids)                         # the warm-up
    reset_launches()
    logits = engine.forward(ids)                # the captured graph
    out["forward_launches"] = read_launches()
    out["forward_ms"] = wall_ms(lambda: engine.forward(ids), reps=3)
    tokens = engine.generate(prompts, MISTRAL_NEW_TOKENS,
                             attention_mask=mask).tolist()
    out["decode_graphs"] = compare_decode(
        engine, prompts, mask, n=MISTRAL_NEW_TOKENS,
        temperatures=(("greedy", 0.0),))
    cache = engine._decoder(len(lens)).cache
    out["ring_slots"] = int(cache.key[0].shape[1])
    out["ring_kv_heads_per_rank"] = int(cache.key[0].shape[2])
    out["ring_gb_per_rank"] = _cache_bytes(cache) / 1e9
    if out["forward_launches"]["block_sparse_fwd"] != n_layer or \
            out["forward_launches"]["flash_attention_fwd"]:
        problems.append(f"window forward launches {out['forward_launches']}")
    if not out["decode_graphs"]["identical"]:
        problems.append("window decode graphs differ from eager decode")
    if out["ring_slots"] != SPARSE_GPT_RING_SLOTS:
        problems.append(f"ring of {out['ring_slots']} slots")
    if rank == 0:
        out["logits_rel_l2"] = _rel_l2(logits, ref_logits)
        out["logits_finite"] = bool(torch.isfinite(logits).all())
        out["parts"], probs = token_parts(
            one, prompt_lists, tokens, ref_tokens,
            SPARSE_GPT_BLOCK["block"], pads=[width - n for n in lens])
        problems += probs
        if not (out["logits_finite"]
                and out["logits_rel_l2"] <= PARALLEL_LOGITS_REL_L2):
            problems.append(f"window logits {out['logits_rel_l2']}")
    out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del engine, one, logits, ref_logits, cache
    free_cuda()
    comm.barrier()
    return out, problems


def parallel_window_engine(tp, layers, one_card=False, seed=0):
    """The window's training engine: Mistral-7B at ``layers`` and n_positions
    32768, micro [1, 16384] (``parallel_tp_engine``)."""
    return parallel_tp_engine(tp, layers, micro=1, seed=seed,
                              one_card=one_card,
                              n_positions=SPARSE_GPT_POSITIONS,
                              sparse_attention=window_sparsity())


def window_batches(n=STEPS, seed=300):
    return [lm_batch(MISTRAL_7B["vocab_size"], 1, SPARSE_GPT_SEQ,
                     seed=seed + i) for i in range(n)]


def one_card_run(make, batches, steps=STEPS):
    """A reference run: losses, grad norms, start and final parameters on
    the host."""
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    free_cuda()
    eng = make()
    start = {k: v.cpu() for k, v in eng.module.state_dict().items()}
    losses, norms, times = train_steps(eng, iter(RepeatingLoader(batches)),
                                       steps)
    out = {"losses": [float(x) for x in losses],
           "grad_norms": [float(x) for x in norms], "step_ms": times,
           "start": start,
           "final": {k: v.cpu() for k, v in eng.module.state_dict().items()}}
    del eng
    free_cuda()
    return out


def tp_run_vs(rank, make, batches, refs, problems, name):
    """``make()``'s tp engine over ``batches`` (captured), its gathered
    parameters against each reference in ``refs`` (name -> reference run)
    within the parallel bounds (rank 0). Returns the run's line."""
    import torch

    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    eng = make()
    losses, norms, times = train_steps(eng, iter(RepeatingLoader(batches)),
                                       len(batches))
    peak = torch.cuda.max_memory_allocated() / 1e9
    params = eng.params                      # gathered: collective
    del eng
    run = {"losses": [float(x) for x in losses],
           "grad_norms": [float(x) for x in norms],
           "step_ms_median": statistics.median(times[CAPTURE_WARMUP + 1:]),
           "peak_allocated_gb_per_rank": peak}
    if rank == 0:
        params = {k: v.cuda() for k, v in params.items()}
        for key, ref in refs.items():
            run[f"vs_{key}"] = vs = parallel_vs(run["losses"],
                                                run["grad_norms"], params,
                                                ref)
            if not parallel_within_bounds(vs):
                problems.append(f"{name} vs {key} outside the bounds: {vs}")
        run["final"] = {k: v.cpu() for k, v in params.items()}
    del params
    free_cuda()
    return run


def parallel_window_train(rank, world, layers, ref, captured=True):
    """The window at tp ``world``, ``layers`` layers, micro [1, 16384]:
    captured against eager (``captured``; the one-card run leaves it to
    the ``sparse_gpt`` phase) with B5 2L / B6 L / B7 L / B4 1 launches
    per step, and against the one-card run ``ref`` on its distinct
    batches (``window_batches``) within the parallel bounds. Returns the
    line, the launches (of the captured-against-eager run, else of the
    comparison) and the problems."""
    problems = []
    per_step = {"block_sparse_fwd": 2 * layers, "block_sparse_dq": layers,
                "block_sparse_dkv": layers, "fused_adamw": 1,
                "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0}
    out = {"per_step": per_step}
    if captured:
        line, launches = parallel_path(
            lambda: parallel_window_engine(world, layers),
            lm_batch(MISTRAL_7B["vocab_size"], 1, SPARSE_GPT_SEQ), STEPS,
            per_step, phase="parallel", part=f"tp{world}_window_train",
            problems=problems)
        out.update(captured_vs_eager=line["captured_vs_eager"],
                   step_ms_median=line["step_ms_median"])
    batches = window_batches(len(ref["losses"]) if ref else STEPS)
    reset_launches()
    run = tp_run_vs(rank, lambda: parallel_window_engine(world, layers),
                    batches, {"one_card": ref} if ref else {}, problems,
                    f"tp{world} window")
    if not captured:
        launches = read_launches()
        for name, per in {**per_step, **UNSEGMENTED}.items():
            if launches[name] != per * len(batches):
                problems.append(f"tp{world} window: {name} {launches[name]} "
                                f"launches, want {per} x {len(batches)}")
    run.pop("final", None)
    out["vs_one_card_run"] = run
    return out, launches, problems


def mask_digests(masks, world):
    """Each dropout mask's digest: a 4-d (probability) mask's as each of
    ``world`` tp ranks keeps it (its heads' slice), a whole-activation
    mask's once."""
    out = []
    for m in masks:
        if m.dim() == 4:
            h = m.shape[1] // world
            out.append([_digest(m[:, r * h:(r + 1) * h]) for r in range(world)])
        else:
            out.append(_digest(m))
    return out


def _digest(t):
    import hashlib

    return hashlib.blake2b(t.contiguous().cpu().numpy().tobytes(),
                           digest_size=16).hexdigest()


def c6_masks(make, world):
    """The digests of the dropout masks ``make()``'s engine draws in its
    first step (each 4-d mask sliced for ``world`` tp ranks)."""
    import deepspeed_tpu_torch.runtime.activation_checkpointing as ac

    free_cuda()
    eng = make()
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing

    real, digests = ac.bernoulli_mask, []

    def recording(*args, **kw):
        mask = real(*args, **kw)
        # a recompute hands the forward's masks back: each counted once
        draws = getattr(checkpointing._current, "draws", None)
        if draws is None or not draws.replaying:
            digests.extend(mask_digests([mask], world))
        return mask

    ac.bernoulli_mask = recording
    try:
        train_steps(eng, iter([lm_batch(MISTRAL_7B["vocab_size"],
                                        MISTRAL_MICRO, MISTRAL_SEQ)]), 1)
    finally:
        ac.bernoulli_mask = real
    del eng
    free_cuda()
    return digests


def c6_engine(tp, one_card=False):
    return parallel_tp_engine(tp, PARALLEL_C6_LAYERS, one_card=one_card,
                              dropout=PARALLEL_C6_DROPOUT)


def parallel_c6(rank, world, ref_digests):
    """Attention-probability dropout under tp (ROADMAP C.6): each rank's
    probability masks are its heads' slice of the one-card engine's at the
    same generator seed (``ref_digests``, one card's masks sliced for
    ``world`` ranks), so the ranks' masks differ; the other masks are one
    card's; the step captured against eager. Returns the line, the
    launches and the problems."""
    from deepspeed_tpu_torch import comm

    problems = []
    mine = c6_masks(lambda: c6_engine(world), 1)
    everyone = comm.all_gather_object(mine)
    probs = [i for i, d in enumerate(ref_digests) if isinstance(d, list)]
    for r, theirs in enumerate(everyone):
        for i, want in enumerate(ref_digests):
            got = theirs[i][0] if isinstance(want, list) else theirs[i]
            if got != (want[r] if isinstance(want, list) else want):
                problems.append(f"rank {r}'s mask {i} is not one card's")
    distinct = all(len({everyone[r][i][0] for r in range(world)}) == world
                   for i in probs)
    if world > 1 and not distinct:
        problems.append("the ranks' probability masks are not distinct")
    line, launches = parallel_path(
        lambda: c6_engine(world), parallel_batch(MISTRAL_MICRO), STEPS,
        PARALLEL_C6_PER_STEP, phase="parallel", part=f"tp{world}_c6",
        problems=problems)
    return {"masks": len(mine), "probability_masks": len(probs),
            "ranks_masks_distinct": distinct,
            "captured_vs_eager": line["captured_vs_eager"]}, launches, problems


def mixtral_witness(batches):
    """Mixtral's one-card reference run again with the rows of each global
    micro batch reversed and its gating noise reversed with them (each
    token keeps its draw and its route; only the order of the sums
    changes): how far rounding alone moves the 12-step update."""
    import numpy as np

    def make():
        eng = parallel_ep_engine(
            1, MIXTRAL_TRAIN_LAYERS, PARALLEL_EP * PARALLEL_MIXTRAL_ROWS,
            one_card=True, **PARALLEL_MIXTRAL_TRAIN)
        draw = eng._gating

        def reversed_noise(batch):
            noise = draw(batch)["gating_noise"]
            L, K, n, E = noise.shape
            rows = batch["input_ids"].shape[0]
            return {"gating_noise": noise.view(L, K, rows, n // rows, E)
                    .flip(2).reshape(L, K, n, E)}

        eng._gating = reversed_noise
        return eng

    flipped = [{k: np.ascontiguousarray(v[::-1]) for k, v in b.items()}
               for b in batches]
    return one_card_run(make, flipped)


def parallel_rank(rank, world, url):
    """One rank of the multi-card run: rank 0's group-less references
    first, then every rank joins the NCCL group and runs the parts."""
    from datetime import timedelta

    import torch

    from deepspeed_tpu_torch import comm

    torch.cuda.set_device(rank)
    t0 = time.perf_counter()
    refs = parallel_train_references() if rank == 0 else None
    ref_s = time.perf_counter() - t0
    comm.init_distributed(init_method=url, rank=rank, world_size=world,
                          timeout=timedelta(seconds=PARALLEL_GROUP_TIMEOUT_S))
    out = {"rank": rank, "references_s": ref_s, "seconds": {}}
    problems = []
    try:
        # ROADMAP A.9 part 2a and C.6
        t = time.perf_counter()
        out["scheduler"], out["scheduler_launches"], p = parallel_scheduler(
            rank, world)
        out["seconds"]["scheduler"] = time.perf_counter() - t
        problems += p
        t = time.perf_counter()
        out["window_serve"], p = parallel_window_serve(rank, world)
        problems += p
        out["window_train"], out["window_launches"], p = \
            parallel_window_train(rank, world, MISTRAL_TRAIN_LAYERS,
                                  refs["window"] if rank == 0 else None)
        out["seconds"]["window"] = time.perf_counter() - t
        problems += p
        t = time.perf_counter()
        out["c6"], out["c6_launches"], p = parallel_c6(
            rank, world, comm.broadcast_object(
                refs["c6_digests"] if rank == 0 else None))
        out["seconds"]["c6"] = time.perf_counter() - t
        problems += p
        for dtype in ("bf16", "int8"):
            t = time.perf_counter()
            out[f"serve_{dtype}"] = parallel_serve(rank, world, dtype)
            out["seconds"][f"serve_{dtype}"] = time.perf_counter() - t
        t = time.perf_counter()
        train, launches, full_launches, p = parallel_mistral_train(
            rank, world, refs, os.path.join(PARALLEL_DIR, "tag"))
        out["seconds"]["train"] = time.perf_counter() - t
        out["train"], out["train_launches"] = train, launches
        out["full_launches"] = full_launches
        problems += p
        t = time.perf_counter()
        out["mixtral"], out["mixtral_launches"], p = parallel_mixtral(
            rank, world, refs)
        out["seconds"]["mixtral"] = time.perf_counter() - t
        problems += p
    finally:
        comm.destroy_distributed()
    for dtype in ("bf16", "int8"):
        s = out[f"serve_{dtype}"]
        if rank == 0:
            if not (s["logits_finite"]
                    and s["logits_rel_l2"] <= PARALLEL_LOGITS_REL_L2):
                problems.append(f"serve {dtype}: logits {s['logits_rel_l2']}")
            problems += [f"serve {dtype}: {x}" for x in s["token_problems"]]
        if not s["decode_graphs"]["identical"]:
            problems.append(f"serve {dtype}: decode graphs differ from eager")
        if s["forward_launches"]["flash_attention_fwd"] != MISTRAL_7B[
                "n_layer"]:
            problems.append(f"serve {dtype}: B1 launches per forward "
                            f"{s['forward_launches']}")
    out["problems"] = problems
    return out


def parallel_rank_main(argv):
    """``chip_smoke.py --parallel-rank RANK WORLD URL OUT``: one rank's
    process; its results go to OUT as JSON."""
    rank, world, url, out = argv
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    result = parallel_rank(int(rank), int(world), url)
    with open(out, "w") as f:
        json.dump(result, f, default=str)
    return 0


def parallel_spawn(world):
    """One process per card (``--parallel-rank``), a file rendezvous under
    build/; every process is waited for or killed."""
    rdv = os.path.join(os.path.abspath(PARALLEL_DIR), "rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    procs, outs, logs = [], [], []
    for r in range(world):
        outs.append(os.path.join(PARALLEL_DIR, f"rank{r}.json"))
        logs.append(open(os.path.join(PARALLEL_DIR, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank",
             str(r), str(world), f"file://{rdv}", outs[-1]],
            stdout=logs[-1], stderr=subprocess.STDOUT,
            env=dict(os.environ, LOCAL_RANK=str(r))))
    deadline = time.monotonic() + PARALLEL_RANK_TIMEOUT_S
    try:
        # a rank that fails leaves the others waiting in a collective: stop
        # them at once
        while time.monotonic() < deadline and any(
                p.poll() is None for p in procs) and not any(
                p.poll() not in (None, 0) for p in procs):
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        for r in failed:
            with open(os.path.join(PARALLEL_DIR, f"rank{r}.log")) as f:
                print(f"--- parallel rank {r} log (tail) ---\n"
                      f"{f.read()[-3000:]}", flush=True)
        raise AssertionError(f"parallel: ranks {failed} failed")
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def phase_parallel():
    """Tensor and expert parallelism (ROADMAP A.9 parts 1 and 2a) over
    NCCL: at world >= ``PARALLEL_MIN_WORLD`` one process per card serving
    and training Mistral-7B at tp 4 and Mixtral-8x7B at ep 4 (the first
    ``PARALLEL_MIN_WORLD`` cards), through the scheduler and the front door
    too, Mistral's window at tp 4, the fused head over the vocab-parallel
    head and the C.6 masks; always, in process on one card, the tp path at
    tp 1 and the ep path at ep 1 (``parallel_one_card``). Returns the
    launches by path."""
    import shutil

    import torch

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    world = torch.cuda.device_count()
    paths = parallel_one_card()
    if world >= PARALLEL_MIN_WORLD:
        if os.path.exists(PARALLEL_DIR):
            shutil.rmtree(PARALLEL_DIR)
        os.makedirs(PARALLEL_DIR)
        free_cuda()
        try:
            results = parallel_spawn(PARALLEL_MIN_WORLD)
        finally:
            shutil.rmtree(os.path.join(PARALLEL_DIR, "tag"),
                          ignore_errors=True)
        r0 = results[0]
        emit({"phase": "parallel", "part": "ranks", "world":
              PARALLEL_MIN_WORLD, "rank0": r0,
              "others": [{k: r.get(k) for k in ("rank", "seconds",
                                                "problems")}
                         for r in results[1:]]})
        problems = [f"rank {r['rank']}: {p}" for r in results
                    for p in r["problems"]]
        if problems:
            raise AssertionError(f"parallel: {problems}")
        paths.update({f"parallel_tp{PARALLEL_TP}_train": r0["train_launches"],
                      f"parallel_tp{PARALLEL_TP}_train_32_layers":
                          r0["full_launches"],
                      f"parallel_ep{PARALLEL_EP}_train":
                          r0["mixtral_launches"],
                      f"parallel_tp{PARALLEL_TP}_scheduler":
                          r0["scheduler_launches"],
                      f"parallel_tp{PARALLEL_TP}_window_train":
                          r0["window_launches"],
                      f"parallel_tp{PARALLEL_TP}_c6": r0["c6_launches"]})
    emit({"phase": "parallel", "part": "done", "nvidia_smi": smi,
          "world": world, "seconds": time.perf_counter() - t0})
    return paths


def main(argv):
    import torch

    usage = (len(argv) == 1 or (len(argv) == 3 and argv[1] in
                                ("--against", "--only") and
                                (argv[1] == "--against"
                                 or argv[2] in ("zero", "data", "mistral",
                                                "neox", "moe",
                                                "train_options",
                                                "sparse_gpt",
                                                "bert_options",
                                                "serving", "frontdoor",
                                                "parallel")))
             or (len(argv) == 6 and argv[1] in ("--zero-rank",
                                                "--parallel-rank")))
    if not usage:
        print(f"usage: {argv[0]} [--against OTHER_CHECKOUT | "
              "--only zero|data|mistral|neox|moe|train_options|sparse_gpt"
              "|bert_options|serving|frontdoor|parallel]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import deepspeed_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    if argv[1:2] == ["--zero-rank"]:
        return zero_rank_main(argv[2:])
    if argv[1:2] == ["--parallel-rank"]:
        return parallel_rank_main(argv[2:])
    if argv[1:2] == ["--against"]:
        ok = phase_against(argv[2])
        print(nvidia_smi_line(), flush=True)
        return 0 if ok else 1
    if argv[1:2] == ["--only"]:
        start_phase()
        smi = phase_device()
        start_phase()
        phase_build()
        start_phase()
        if argv[2] == "zero":
            emit({"zero_launches_by_path": phase_zero()})
        elif argv[2] == "mistral":
            emit({"mistral_launches_by_path": phase_mistral()[0]})
        elif argv[2] == "neox":
            emit({"neox_launches_by_path": phase_neox()})
        elif argv[2] == "moe":
            emit({"moe_launches_by_path": phase_moe()})
        elif argv[2] == "train_options":
            flash_auto_sweep()
            free_cuda()
            emit({"train_options_launches_by_path": phase_train_options()})
        elif argv[2] == "sparse_gpt":
            import torch as _torch

            window = [c for c in block_sparse_cases()
                      if c[0] == "gpt_window_causal_b128_d128"]
            check_sparse_case(window[0], _torch.Generator().manual_seed(20),
                              _torch.device("cuda"))
            free_cuda()
            time_block_sparse_gpt()
            emit({"sparse_gpt_launches_by_path": phase_sparse_gpt()})
        elif argv[2] == "bert_options":
            emit({"bert_options_launches_by_path": phase_bert_options()})
        elif argv[2] == "serving":
            emit({"serving_launches_by_path": phase_serving()})
        elif argv[2] == "frontdoor":
            emit({"frontdoor_launches_by_path": phase_frontdoor()})
        elif argv[2] == "parallel":
            emit({"parallel_launches_by_path": phase_parallel()})
        else:
            emit({"data_launches": phase_data()[0]})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    started = time.perf_counter()
    phase_seconds = {}

    def run(name, fn):
        """One phase, its wall seconds kept, then what it left freed."""
        t0 = time.perf_counter()
        start_phase()
        out = fn()
        free_cuda()
        phase_seconds[name] = time.perf_counter() - t0
        return out

    smi = run("device", phase_device)
    run("build", phase_build)
    kernels = run("kernel", phase_kernel)
    serve_launches = run("serve", phase_serve)
    run("small", phase_small)
    launches = run("train", phase_train)
    data_launches, segment_times = run("data", phase_data)
    ckpt_launches = run("checkpoint", phase_checkpoint)
    sparse_launches = run("sparse_train", phase_sparse_train)
    run("small_capture", phase_small_capture)
    run("small_train", phase_small_train)
    zero_paths = run("zero", phase_zero)
    mistral_paths, mistral_shape = run("mistral", phase_mistral)
    neox_paths = run("neox", phase_neox)
    moe_paths = run("moe", phase_moe)
    option_paths = run("train_options", phase_train_options)
    sparse_gpt_paths = run("sparse_gpt", phase_sparse_gpt)
    bert_paths = run("bert_options", phase_bert_options)
    serving_paths = run("serving", phase_serving)
    frontdoor_paths = run("frontdoor", phase_frontdoor)
    parallel_paths = run("parallel", phase_parallel)
    emit({"phase_seconds": phase_seconds,
          "total_seconds": time.perf_counter() - started})
    paths = {"serve": serve_launches, "train": launches,
             "checkpoint": ckpt_launches, "sparse_train": sparse_launches,
             **zero_paths, "data": data_launches, **mistral_paths,
             **neox_paths, **moe_paths, **option_paths, **sparse_gpt_paths,
             **bert_paths, **serving_paths, **frontdoor_paths,
             **parallel_paths}
    for entry in kernels:
        # each slice's main path, its counts set to 0 just before it: serving
        # runs B1, GPT training, the checkpoint path, ZeRO (stages 0-2, and
        # stage 3), the gradient exchange, the packed data path and
        # Mistral's training B1-B4 (B1-B3 of the data path in their segment
        # variant), Pythia's and Mixtral's training B1-B4 (BLOOM serves
        # without B1: ALiBi), BERT training under BigBird B4-B7, and the
        # training options' runs (each remat policy, dropout, PLD, BLOOM's
        # fused head, chunked attention), Mistral's sliding window on the
        # GPT block-sparse route (B5-B7, B4), and BERT-Large's training
        # options (each remat policy under dropout, PLD: B5-B7, B4; the
        # dense BERT: B4), and serving's forward graph (B1 per layer in
        # each replay) and scheduler (its cache path runs no kernel), and
        # the front door's runs (none either), and the parallel phase's
        # tp path (Mistral's widths at tp 1: B1-B4) and ep path (Mixtral's
        # at ep 1: B1-B4), and its window through the tp path at tp 1
        # (B5-B7, B4), its scheduler (no kernel on the cache path) and the
        # C.6 check's steps (B4: dropout keeps attention on einsum).
        # "launches" is the count on the newest path that runs the kernel
        name = entry["name"]
        entry["launches_by_path"] = {p: counts[name] for p, counts in paths.items()}
        entry["launches"] = (parallel_paths["parallel_tp_window_train"][name]
                             or parallel_paths["parallel_tp_train"][name]
                             or parallel_paths["parallel_ep_train"][name]
                             or serving_paths["serving_forward"][name]
                             or bert_paths["bert_selective"][name]
                             or sparse_gpt_paths["sparse_gpt_train"][name]
                             or option_paths["remat_selective"][name]
                             or option_paths["pld"][name]
                             or moe_paths["moe_train"][name]
                             or neox_paths["neox_train"][name]
                             or mistral_paths["mistral_train"][name]
                             or data_launches[name]
                             or zero_paths["grad_exchange"][name]
                             or zero_paths["zero_stage3"][name]
                             or zero_paths["zero"][name]
                             or sparse_launches[name]
                             or ckpt_launches[name] or launches[name])
        if not entry["launches"]:
            raise AssertionError(f"{name} never ran on a main path")
        if name in segment_times:
            # B1-B3's segment variant at the packed 1.3B batch (data phase)
            entry["segment_ms"] = segment_times[name]["ms"]
            entry["segment_unsegmented_ms"] = segment_times[name][
                "unsegmented_ms"]
            entry["segment_bound_ms"] = segment_times[name][
                "segment_bound_ms"]
        if name in mistral_shape:
            # B1-B3 at Mistral's training attention [2, 4096, 32, 128]
            entry["mistral_shape"] = {
                k: mistral_shape[name][k]
                for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "library", "cudnn_ms")}
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
