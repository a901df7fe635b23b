#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``pyspark_tf_gke_tpu_torch``) on one card.

``python3 chip_smoke.py`` from the root of a checkout:

1. reports the card (``nvidia-smi`` name and power limit, torch/CUDA
   versions, compute capability; 9.0 is required);
2. builds the hand-written kernels from ``pyspark_tf_gke_tpu_torch/csrc``
   and prints ptxas's registers, shared memory and spills; a tensor-core
   (``wgmma``) kernel that spills fails the run;
3. holds each kernel against its plain PyTorch version on the card at
   the main paths' shapes, in bf16 and f32 — the serving kernels (K2f
   also at ragged S = 200 and 77 and on q/k/v views of one [B, S, 3, H,
   D] tensor; K1 at S = 1 and 8 on its decode variant, at fills on its
   split boundaries and at the serving decode shape, and at S = 256 and
   at S = 512 with 12/4 GQA on its chunk variant (bf16) or first design
   (f32), float and int8 pages, queries with no key giving zeros, each
   call on the variant its plan names), the training
   kernels (K2f, K2dq and K2dkv at B=16 S=512 H=12 D=64 and at ragged
   S = 200 and 77: causal, causal + segments, and key padding + segments
   + causal with an empty row and a fully masked batch row, at S = 200
   also on q/k/v views of one [B, S, 3, H, D] tensor with an expanded
   dO; K3 and K3b, with and without the residual, at [8192, 768] and
   [8, 768] and at D = 1024, 1280, 1600, 4096, 100 and 2050, and 1280
   from an unaligned base), and the ResNet
   kernels (K4f, K4dx and K4dw at four of
   ResNet-50's 1x1-conv shapes, a ragged one and one whose K and N are
   not multiples of 8; K5f, K5dx and K5dw at
   the four stride-1 3x3 shapes, a ragged one and one whose K and N are
   not multiples of 8, with and without the transform and the
   statistics); 3b. K2f, K2dq and K2dkv at head widths 128 (bf16 on the
   tensor cores, f32 on the CUDA cores), 32 and 80 (the CUDA cores, 80
   on the 128-wide instantiation) in three mask cases, each call's
   counter moving and ``flash_plan`` naming the expected design, and
   K1 at head_dim 128 (its decode variant at S = 1 and 4, bf16 and f32,
   float and int8 pages, at fills {0..1024} and the serving decode
   shape, over 8, 4, 2 and 1 KV heads so that its CTAs hold 1, 2, 4 and
   8 query rows; the 256-token piece on its chunk variant in bf16 over
   float and int8 pages and with GQA, the first design in f32; the
   serving shape and the piece also timed on the first design
   in turns with the new variants) — and times kernel, plain version and a
   library yardstick
   with CUDA events (K1 at S = 1 at fills {0..1024}, 716 each and 1024
   each, and at S = 256, against SDPA over the gathered pages; K3 at
   [8192, 768] bf16 with and without the
   residual against F.layer_norm; K3b against
   native_layer_norm_backward; K2f at B=8 S=1024 and B=16 S=512; K2dq and K2dkv at
   B=16 S=512 against the SDPA backward, which computes dQ, dK and dV
   together, on [B, S, H, D] views and on contiguous [B, H, S, D]
   tensors; K4: on all 16 shapes of a ResNet-50 step, summed over its 36
   calls; K5: on the four stage shapes, summed over its 13 calls, against
   cuDNN; K1, K3, K3b, K2f, K2dq, K2dkv, K5f, K5dx, K4f, K4dx and the bf16
   K4dw and K5dw and their yardsticks also replayed from a CUDA graph,
   which takes the host's launch cost out; K2 also at D 128 and D 80
   and K1 at D 128);
3c. the ring's block entry ``flash_attention_block`` (K2f, and K2dq /
   K2dkv with ``delta - g_lse``) at B=8 S=512 H=12 in bf16 and f32 at D
   64 and bf16 at D 128, a fully masked batch row and a nonzero lse
   cotangent: out, lse (NEG_INF on the empty rows) and dQ/dK/dV against
   the plain versions, every counter moving; then the ring's arithmetic
   on one card: S split into 4 blocks, the padding covering the last
   whole, each query block against each K/V block through the entry,
   merged by logsumexp, output and gradients equal to K2f/K2dq/K2dkv over
   the whole sequence (bf16 and f32); the entry timed forward and
   backward, eager and graph-replayed, beside its plain version and
   ``aten._scaled_dot_product_efficient_attention`` with the logsumexp;
3d. K6, the int8-weight matmul (``x @ dtype(q * scale)``), against its
   plain version at GPT-small's weights (768x768, 768x3072, 3072x768,
   768x32000) and the cb --spec pair's 64x259, M = 1, 8 and 40, bf16
   (relative L2 1e-2) and f32 (phase 3's f32 rule); each case timed
   eager and graph-replayed beside its plain version, ``torch.matmul``
   on the already dequantized weight and its bound; the grouped call
   (a layer's query, key and value, one launch) against each plain
   product; a split-K and a grouped call each one kernel in the
   profiler's list (no second pass), a captured replay == the eager
   call bit for bit; the record is one GPT-small decode step at M = 8
   (49 launches, beside the yardstick's 73 products);
4. serving main path: serves a full-width GPT-small paged bundle
   (random weights from a numpy seed, int8 export) through
   ``BundleServer`` + the HTTP server with 8 continuous slots at the
   server's defaults (decode-ahead depth 1, the decode chunk a replayed
   CUDA graph; a greedy and a sampled warm-up capture both 16-step
   graphs): 12 ``/v1/generate`` requests from 3 client threads (greedy
   and seeded top-p) and one ``/v1/score``; every serving kernel's launch
   counter must move during this phase, K1's decode variant and K6 (the
   int8 weights stay int8 on the card) among them, and exactly the two
   graphs must exist; prints new tokens/s beside the
   152.3 of an engine launching its decode steps one by one, and
   ``/metrics``' ``serve_mfu`` at ``--peak-flops 989e12`` (must be > 0);
4b. profiles one batched prefill admission and two replays of the
   engine's captured 16-step decode chunk (host wall time against
   device-busy time, top kernels, the Dense layers' K6 time; fails
   unless K6 and K1's decode kernel show
   inside the replay), then times three replayed chunks unprofiled;
4d. the captured decode chunk against eager launches of the same body
   on the same GPT-small model (8 slots, chunk 16, 16 requests of which
   5 sampled with their own seeds): the tokens must agree bit for bit,
   and so must the engines at decode-ahead depths 0, 1 and 2; a
   replay-only run must move K1's decode counter by exactly its decode
   steps x 12 layers, and K6's by its decode steps x the launches a step
   reckoned from the model's int8 Dense groups (49 on GPT-small);
   ``adaptive_chunk`` must dispatch only sizes 8 and 16; prints each
   depth's new tokens/s and ``step_phases``, and each graph's capture
   time;
5. checks serving parity on the card: the engine's f32 greedy tokens
   equal the dense ``generate``'s, full-width bf16 prefill logits
   through the kernels agree with the plain versions, and so do two
   256-token chunked-prefill pieces through the paged model (every K1
   call on its chunk variant);
4c. chunked prefill on the serving path, the JAX bench's chunked
   configuration at full width (``bench.py:1196-1199``): GPT-small at
   2048 positions (int8 export), 8 slots, chunk 16, 64-token pages,
   ``prefill_chunk`` 256, ``step_token_budget`` 384; 32 requests, every
   4th with a 1024-token prompt and the rest 64, 64 new tokens each,
   through an unchunked and a chunked engine at decode-ahead depth 1,
   each warmed by one whole run (its graphs captured there), then in
   turns (unchunked, chunked, chunked, unchunked). Every piece's K1 calls
   must take the chunk variant and every serving kernel must launch;
   an f32 run of the same arrivals (the full width cut to 2 layers)
   must give the unchunked engine's tokens exactly. Prints the short
   requests' time to first token and largest gap between tokens, new
   tokens/s and the engine's step times of each run, and the ratios of
   the two engines' means;
4e. the radix prefix cache, the JAX bench's shared-prefix traffic
   (``bench.py:1330-1400``, the non-smoke shape) on GPT-small: 16
   requests sharing a 512-token system prompt, 32-token suffixes, 16 new
   tokens, 4 slots, chunk 8, 64-token pages, pieces of 128, the pool
   sized as the bench sizes it; the cache off, then warmed and on, then
   the cached pages exported, packed, unpacked and imported into a fresh
   engine: the tokens must agree three ways, the prefill tokens must be
   the warm's 512 plus the suffixes (the suffixes alone after the
   import), the page audit green after every step; prints new tokens/s
   both ways and the hit rate;
4f. in-engine speculative decoding: (a) the JAX bench's ``cb --spec``
   pair (``bench.py:1479-1560``: a 12-layer hidden-64 target and a
   1-layer hidden-32 draft distilled on its greedy rollouts, trained
   here by the port's ``_train_lm``; f32, 2 slots, chunk 64, adaptive
   chunks, k = 5, 8 prompts of 16 tokens, 128 new tokens each) through
   the engine with speculation on and off, warmed, then in turns: on ==
   off token for token, the accept rate strictly between 0 and 1, no
   timed run capturing a graph; (b) phase 4's GPT-small bundle with a
   random 1-layer hidden-768 draft bundle over HTTP (``--spec-tokens 5
   --draft-bundle``), then phase 4's 12 requests through engines with
   speculation off, a self-draft and the random draft (8 slots, chunk
   16, depth 1): every request completes, the K1, K3 and K2f counters
   move, K1's verify launches are exactly rounds x layers on the variant
   ``paged_plan`` names for S = 6 (the exit feeds on the decode
   variant), replayed spec chunks equal eager launches of the same body
   bit for bit (greedy and sampled), and the f32 full width cut to 2
   layers gives spec off's greedy tokens with both drafts; prints new
   tokens/s, the share of bf16 greedy tokens identical to spec off, the
   accept rates and a replayed spec chunk's device and wall time;
   (c) the standalone driver's device and host loops on the trained pair
   equal ``generate`` and each other's stats;
4g. the replica's fleet contract on phase 4's bundle (``BundleServer``
   over HTTP, 8 slots, chunk 16, decode-ahead depth 1; the f32 gates on
   the same width cut to 2 layers): (a) 8 greedy prompts streamed and
   sent blocking, each alone (a stream's tokens == the blocking
   request's, ``[DONE]`` last), then all 8 at once both ways in turns
   (prints TTFT to the first event, the mean gap between events, new
   tokens/s streamed and blocking); (b) f32: a stream cut after 10
   events by closing the socket, its slot freed, a ``continuation`` with
   those ids == the uncut stream; (c) ``/v1/prefill`` on a ``--role
   prefill`` server into ``/v1/kv_import`` on a ``--role decode`` one,
   in bf16 and f32: the decode server prefills exactly the tokens past
   the imported pages, and in f32 gives the tokens of a server that
   imported nothing; (d) ``deadline_ms`` 1 -> 504, a stream cut by its
   deadline mid-run, then ``/loadz`` active 0 and the page audit; (e)
   ``--tenants`` light=3, noisy=1 flooded: admitted tokens 3:1 +- 15%
   while both are backlogged, a quota'd tenant's 429 with
   ``Retry-After`` and an oversize ask's 400; (f) drain: new requests
   503 with ``reason``, in-flight ones finish, ``/loadz`` draining,
   ``/livez`` live; (g) ``/loadz``'s key set == the contract's 17 keys
   on every server; K1's decode and chunk variants, K2f, K3 and the
   graph replays must all move;
4h. the replica's operator contract on phase 4's bundle (the f32 gates
   on the 2-layer cut): (a) ``num_beams`` 4 over HTTP, 4 prompts of 64
   tokens, 64 new tokens: bf16 ``beam_score`` within 2e-2 of the plain
   model's rescoring of the sequence, f32 sequences and scores == the
   search with ``use_kernels=False`` (1e-5), K2f and K3 moving, ms a new
   token printed; (b) ``POST /admin/reload`` to a second bundle
   (generation 2) under 8 open streams: exactly one terminal a stream,
   generation 2 on ``/healthz`` and ``/loadz``, tokens == a fresh
   server's on that bundle (bf16 and f32), 409 during a reload, a
   failing load (502, nothing swapped) and a failing canary (502,
   rolled back) leave the old generation serving; the reload's wall
   and the first request's after it printed; (c) ``/admin/profile``
   for 4 steps under traffic: the Chrome trace names K1's decode kernel,
   ``profile_trace_written`` carries the step window, a second capture
   while armed 409; (d) ``--step-timeout 0.5`` with one device step held
   2 s: every waiter's ``EngineWedged`` within the timeout plus one
   poll, ``/livez`` 503 while wedged, the rebuild's recaptured graphs
   give the tokens of before, the reap counter and the heartbeat move;
   (e) ``/metrics``' request and token counters == the phase's own, one
   trace per ``X-Request-Id`` sent, ``runtime_live_array_bytes`` > 0,
   new tokens/s traced against untraced in turns; (f) a bundle naming a
   locally trained BPE tokenizer serves ``/v1/generate``; the card's
   allocated memory after two more reloads within 5% of its level after
   a warm-up before them (the main server alone);
4i. int8 weights resident: phase 4's weights exported int8 and with
   ``quantize=False`` and loaded: the int8 load's allocated bytes within
   5% of the reckoned int8 elements + scales + unquantized leaves, every
   quantized path int8 (no float copy); each load's MiB and its replayed
   16-step 8-slot decode chunk profiled (device time, K6 or cuBLAS);
4j. the dense slot-cache engine: a dense GPT-small bundle (int8) served
   over HTTP with ``--continuous-slots 8`` and phase 4's traffic (K6, K3
   and K2f launch, K1 does not, the decode chunk replays its graph; its
   device time beside the paged chunk's); bf16 greedy tokens against the
   paged engine on the same weights (the identical share printed); f32
   at the 2-layer cut: engine == ``generate`` with the kernels and
   without, the prefix LRU warmed with 512 tokens hits every request and
   gives the cache-off tokens, pieces of 256 the unchunked tokens; the
   trained cb --spec pair exported dense int8: spec on == off;
6. training main path: ``lm_pretrain.main`` on a seeded synthetic text
   corpus at the GPT-small width (hidden 768, 12 layers, 12 heads, FFN
   3072, seq 512, batch 16, bf16, Adam 3e-4), 2 epochs x 10 steps with
   ``--export-bundle``; the losses must be finite and fall from epoch 1
   to epoch 2, every training kernel's counter must move, and the
   exported bundle must load and generate on the card; then profiles
   two steady training steps;
6c. the rest of the LM training plane at GPT-2's vocabulary (50257, a
   local WordLevel tokenizer of that size saved with ``save_pretrained``):
   (a) a seeded Zipf corpus packed by the port's text bridge into token
   shards and their sidecar, then ``lm_pretrain --data-format tokens
   --vocab-chunks 8 --optimizer adafactor --weight-decay 0.01
   --async-checkpoint --checkpoint-every-steps 5`` at GPT-small width
   (seq 512, batch 16, bf16), 2 epochs x 10 steps with an int8 export:
   finite losses falling from epoch 1 to 2, K2f, K2dq, K2dkv, K3 and K3b
   launched, ``train_steps_total`` up by 20, the steps on disk and both
   ``history.json`` files equal to the run's; ``--resume`` continues the
   step count to 30, and a ``--optimizer lamb`` run trains 10 steps; the
   stall of an asynchronous save on the next step against a synchronous
   one, in turns; (b) the chunked loss against the dense f32-logit loss
   at B=16 S=512 V=50257 E=768 bf16: loss, argmax and the gradients of
   hidden, kernel and bias within the stated tolerance, each path's
   peak allocated memory over loss and backward (the chunked one at
   least 1 GiB lower) and its ms; (c) five LAMB and Adafactor updates of
   a flax-shaped tree on the card against the same updates on the CPU
   (1e-5 of each leaf's largest value); (d) ``lm_eval`` on (a)'s bundle
   (perplexity, a greedy and a 4-beam sample; K6, K2f and K3 launched),
   then ``--endpoint`` against a ``BundleServer`` on the card serving it
   (finite mean NLL);
7. checks training parity on the card: a 2-layer f32 model trains 3
   steps with the kernels and with ``use_kernels=False`` from one init
   (losses and step-0 gradients agree), and full-width bf16 step-0 loss
   and gradients (whole tree and worst tensor) through the kernels agree
   with the plain versions;
7b. a training step at GPT-2 large's widths (hidden 1280, 20 heads of
   64, FFN 5120; 2 layers, bf16, batch 4 x 128): step-0 loss and
   gradients through the kernels against ``use_kernels=False`` under
   phase 7's bf16 limits, one Adam step, and the K3 and K3b counters
   must move (LayerNorm at D = 1280);
7c. a training step at a head width of 128 (``--hidden-size 1024
   --num-heads 8``, FFN 4096; depth cut to 2 layers, bf16, batch 4 x
   512) against ``use_kernels=False`` under phase 7's bf16 limits, every
   training kernel's counter moving; then a paged bundle of those widths
   served over HTTP for three greedy requests (K2f at D 128 in prefill,
   K1's decode variant at D 128 in decode) and an f32 copy's engine
   holding the dense ``generate``'s tokens;
7d. BERT fine-tuning main path: ``bert_finetune.main`` at BERT-base
   (vocab 30522, hidden 768, 12 layers, 12 heads, FFN 3072; seq 128,
   batch 32, bf16, random weights from a numpy seed) on TFRecord shards
   the port's writer writes from a numpy seed (every third row padded),
   ``--objective classification`` 2 epochs x 10 steps (the loss must fall
   from epoch 1 to 2), then ``--objective mlm`` 2 x 5; the losses finite
   and K2f, K2dq, K2dkv, K3 and K3b launched in each; prints ms/step and
   profiles two steady steps;
7e. BERT training parity: a 2-layer f32 model at the full width trains
   3 steps with the kernels and with ``use_kernels=False`` from one init
   (losses and step-0 gradients agree), and BERT-base bf16 step-0 loss
   and gradients through the kernels agree with the plain versions
   (phase 7's limits);
8. ResNet-50 training main path: ``Trainer`` on ``ResNet50(norm_variant=
   "fused")`` (bf16 over f32 weights and statistics, Adam 1e-3), 2 epochs
   x 10 steps on one batch of 64 images at 224^2; every K4 counter must
   move by 36 per step (and no K5 counter), the loss must be finite and
   fall from epoch 1 to 2, every running statistic must leave its init,
   and one ``evaluate`` (``train=False``) must launch K4f 36 times and
   nothing else and leave the statistics as they were; then times the
   step, profiles two steps, and times the ``bn`` variant's step (cuDNN
   convs, no port kernel);
9. checks ResNet-50 ``fused`` training parity on the card: one step
   through the kernels against ``use_kernels=False`` from one init with
   every norm3 scale non-zero — f32 at full depth on 8 images of 64^2,
   bf16 on the full path — and every K4 call of the step against its
   plain version on the same inputs;
10. ResNet-50 ``fused3`` training main path, as phase 8: every K4
    counter must move by 36 per step and every K5 counter by 13, and
    ``evaluate`` must launch K4f 36 and K5f 13 times and nothing else;
    then times and profiles the step beside phase 8's;
11. checks ``fused3`` training parity as phase 9, every K4 and K5 call
    held against its plain version;
12. one training step of each other variant (``bn_f32``, ``gn``,
    ``none``, ``nf``, ``nf`` and ``fused3`` with the s2d stem; bf16, 8
    images of 64^2): finite loss, gradients and parameters, and K5
    launched under ``fused3``;
13. the reference-parity training plane (P9), with every port kernel's
    counter at 0 before it and read after (it runs none: cuDNN convs,
    cuBLAS products, PyTorch's elementwise ops, as the JAX package runs
    these in XLA): (a) loss parity in f32 (no TF32) as
    ``tools/loss_parity.py`` trains the JAX side, from the JAX run's own
    initial parameters (the models' own init at seed 1337,
    ``utils/seeding.jax_init_params``: flax's Keras glorot-uniform under
    ``jax.random.key(1337)``, recomputed in numpy): CNN-B1 on its
    copy of ``make_spot_arrays(128, 256, 320)`` (batch 16, 30 epochs,
    in order, Adam lr 1e-3 eps 1e-7) and the MLP on
    ``make_health_arrays(4096)`` (batch 16, 20 epochs), gated as
    ``compare`` / ``compare_cls`` gate the JAX run against the TF runs
    of ``tools/parity_report.json`` (read as data: final loss <= TF best
    x 1.6; final MAE <= TF best x 1.35, accuracy >= TF best - 0.05; the
    loss falls) and the first three epochs within 1% of the recorded
    JAX losses; (b) ``train.cli`` end to end: image mode on 320 PNGs of
    ``make_synthetic_image_dataset`` at 256x320 (B1, bf16, batch 32, 2
    epochs of 8 steps) and CSV mode on the 18,154-row reference CSV
    (epochs of 96 steps), each with a save every epoch, a fault in
    epoch 2 and one restart: the restart resumes at the save, the run
    ends 2 epochs past it, ``history.json``, the run notes and
    ``label_map.json`` written, every loss finite; then
    ``ManualImageChecker`` over every image of the image run (mean and
    max pixel error); (c) a CNN-B1 step at batch 32 x 256x320 in f32 and
    bf16 (ms/step, images/s, two steps under ``torch.profiler``: host
    wall against device busy, top device ops) and an MLP step;
14. P10: K2f, K2dq and K2dkv at ViT-Base's S = 197 (non-causal, an
    all-ones key mask) against their plain versions in bf16 and f32,
    timed at B=64 beside SDPA; (a) a 2-layer ViT at ViT-Base's width
    (batch 8 of 224^2) through the kernels against ``use_kernels=False``
    in bf16 and f32 (loss, logits, every gradient; one step's launches
    gated); (b) ViT-Base/16 trained at the JAX bench's shape (batch 64 of
    224^2, 1000 classes, bf16, Adam 1e-3; 2 + 10 steps): K2f, K2dq,
    K2dkv 12 and K3, K3b 26 launches a step, finite losses, ms/step,
    images/s, device busy and top ops; (c) a 2-layer MoE-BERT (8 experts,
    top 2, every 2nd layer) through the kernels against plain, the plain
    MoE layer handed the kernel run's inputs so both route alike (picks
    and aux equal, router gradients and the rest held as (a)); then
    ``bert_finetune`` at phase 7d's flags dense and with ``--num-experts
    8`` (K2/K3 launches equal, ``moe_aux_loss`` finite) and a dense and
    an MoE step timed in turns, the einsums' share of device time; (d)
    the port's ``etl/bootstrap.py`` at its defaults on ``cuda`` and on
    ``cpu`` over one CSV (rows, width, k, iterations and the round trip
    equal, silhouettes within 1e-3), the KMeans fit on both (centres,
    cost, ``n_iter``), a Lloyd iteration's device ms, no port kernel
    launched; (e) a CNN-B1 ``Trainer`` with ``mu_dtype=torch.bfloat16``
    on the card against the host (5 steps, losses within 1e-3) and the
    JAX-init replay's host seconds for CNN-B1 at 256x320;
15. P11a, the training mesh on one card (a one-rank NCCL world and a
    ``DeviceMesh``): (a) ``lm_pretrain`` at its defaults (GPT-small,
    seq 512, batch 16; 2 epochs x 3 steps) with ``--mesh-shape
    fsdp=1,tp=1`` against the run without one, bf16 in turns (plain,
    mesh, mesh, plain) and f32: losses within 1e-5 relative in f32 and
    5e-3 in bf16, K2f/K2dq/K2dkv 12 and K3/K3b 25 launches a step on
    both, the step times side by side; (b) ResNet-50 fused3 (bf16, batch
    64 of 224^2) on a ``dp=1`` mesh against no mesh, steps in turns from
    the same weights: K4 36 and K5 13 launches a step on both, losses
    within 2e-3 and the running statistics within 1e-2 of their scale;
    (c) ``bert_finetune`` at phase 7d's flags with ``--mesh-shape
    dp=1,sp=1``: finite losses and phase 7d's launches a step; (d) two
    ranks of one gloo world on the one card (NCCL refuses them; gloo
    takes the collectives the mesh calls on CUDA tensors): a 2-layer
    GPT-small (f32, vocabulary 32000, batch 16 x 512, padding by row) at
    ``tp=2`` (6 heads a rank on the kernels, the vocabulary split),
    ``dp=2`` and ``fsdp=2``, 3 Adam steps against the run without a
    mesh: losses within 1e-5 relative, launches a step equal;
16. P11b-serve, tensor-parallel serving over the serve wire:
    ``serve.main --tp 2 --num-processes 2`` as two processes of one gloo
    world on the card (rank 0 on HTTP, rank 1 replaying in
    ``serve_worker_loop``; NCCL refuses two ranks on one card) against a
    one-process server of the same bundle in this process, with phase
    4's flags (8 slots, chunk 16, pieces of 256); first K6, K1 and K2f
    against their plain versions at a rank's shapes (K6's weight slices,
    6 heads); (a) GPT-small bf16 (6
    heads a rank): sequential greedy requests and a score batch, after
    which each rank's K1, K2f and K3 launches equal the one-process
    server's, the score within 0.005 nats a token and at least a
    quarter of the greedy tokens identical; then phase 4's mix
    (12 requests from 3 clients, a sampled one repeated, an SSE stream,
    4 beams, a radix hit under ``--prefix-cache``), the score and the
    share again, and ms a decode step at 8
    slots for both (gloo's host staging, not a tp speed), the
    tp chunk launched eagerly (gloo's collectives cannot be captured);
    (b) the f32 copy at the 2-layer cut: greedy tokens equal the
    one-process server's, and with a draft (the target's bundle) and
    ``--spec-tokens 3`` the same tokens with drafts accepted; (c) int8
    weights: the sequential traffic, each
    rank's K6, K1, K2f and K3 launches equal the one-process server's;
    (d) in (b) ``/v1/prefill`` on one server feeds ``/v1/kv_import`` on
    the other, both ways, each then giving its own prefill's tokens; (e)
    at the end of (c) SIGTERM on rank 0 with a request in flight: it
    completes and both ranks exit 0;
17. prints one ``{"kernels": [...]}`` line, then
18. ``{"ok": true, "device": {...}}`` as the last line.

It takes no arguments. Any failed check exits non-zero. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import random
import shutil
import statistics
import http.client
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PORT_PKG = ROOT / "pyspark_tf_gke_tpu_torch"

# H100 SXM data-sheet peaks (dense) — the bound is the larger of bytes
# over memory rate and operations over the peak for the inputs' type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# Tolerances of kernel vs plain version on the same inputs. f32: both
# sides compute in f32 and differ by summation order and exp/rsqrt
# rounding (a few ulps of O(1) values). bf16: the kernels keep scores
# and accumulators in f32 and round once at the output (bf16 K2f also
# rounds its unnormalised P, as the TPU kernel does), while the plain
# versions round the normalised probabilities (and dequantized pages)
# to bf16 before the P.V product — allow 2 bf16 ulps relative.
# Attention outputs average many values and can be small (|out| ~ 0.05
# in late rows), so bf16 also requires the relative L2 error of the
# whole tensor to stay under 1e-2 (a few bf16 roundings of ~2e-3 each);
# a fault confined to the bf16 instantiation moves that by far more.
TOL = {"float32": dict(atol=5e-5, rtol=1e-5, rel_l2=None),
       "bfloat16": dict(atol=2e-2, rtol=1.6e-2, rel_l2=1e-2)}
# Column sums over 8192 rows (LayerNorm dscale/dbias, f32 on both sides
# from the same inputs, summed in another order): absolute error within
# 1e-4 of the largest reference sum (a few f32 roundings of a sum of
# 8192 terms), and relative L2 within 2e-5.
SUM_REL_MAX, SUM_REL_L2 = 1e-4, 2e-5


# the card as `nvidia-smi --query-gpu=name,power.limit` names it, set by
# main() and printed beside the serving phases' times
CARD = "card not queried"


class SmokeFailure(RuntimeError):
    pass


def query_card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, kept
    in ``CARD`` for the lines that print a time."""
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    CARD = smi[0] if smi else "nvidia-smi: no output"
    return CARD


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing -------------------------------------------------------------------


def cuda_ms(fn, warmup: int = 3, iters: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the mean per-call time of ``iters``
    back-to-back calls, from CUDA events (after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, calls: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a
    CUDA graph and replayed, so no host launch cost reaches the device's
    timeline (``cuda_ms`` of eager calls includes it where the host is
    slower than a short kernel)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, warmup=2, iters=3, reps=5) / calls
    del graph
    return ms


def bound(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(out, ref, dtype_name: str, what: str, tol=None) -> float:
    import torch

    out, ref = out.float(), ref.float()
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err = (out - ref).abs()
    tol = TOL[dtype_name] if tol is None else tol
    ok = bool((err <= tol["atol"] + tol["rtol"] * ref.abs()).all())
    max_err = float(err.max()) if err.numel() else 0.0
    rel = float(err.norm() / ref.norm().clamp_min(1e-30))
    if tol["rel_l2"] is not None:
        ok = ok and rel <= tol["rel_l2"]
    log(f"  {what}: max_abs_err {max_err:.3e} (tolerance atol "
        f"{tol['atol']:g} + rtol {tol['rtol']:g}*|ref|), relative L2 "
        f"{rel:.2e} (tolerance {tol['rel_l2']}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{what}: kernel disagrees with its plain version")
    return max_err


def ptxas_report(build_log: str) -> dict:
    """``{entry function: {"used": "Used ... registers, ...",
    "spill_stores": bytes, "spill_loads": bytes}}`` from ``nvcc
    -Xptxas=-v`` output."""
    import re

    report, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = {"used": "", "spill_stores": 0, "spill_loads": 0}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[fn]["spill_stores"] = int(m.group(1))
            report[fn]["spill_loads"] = int(m.group(2))
        elif "Used " in line:
            report[fn]["used"] = line.split("Used ", 1)[1].strip()
    return report


# -- phase 3: kernels against their plain versions ----------------------------


# LayerNorm widths (D, rows) held against the plain versions: the LM's
# 768 (8192 rows, a training step's, and 8), 1024 (the narrow design's
# widest), GPT-2 large's 1280 and XL's 1600, 4096, and two whose rows
# are not a whole number of 16-byte chunks: 100 (narrow) and 2050 (the
# wide design's scalar loads); 1280 also from a base 2 or 4 bytes off 16
# (the scalar loads again)
LN_CHECK_WIDTHS = ((768, 8192), (768, 8), (1024, 512), (1280, 512),
                   (1600, 512), (4096, 512), (100, 512), (2050, 512))


def _ln_inputs(torch, dev, g, rows, d, dtype, aligned=True):
    """x, r, dy ``[rows, d]`` of ``dtype`` (from a base one element past
    a 16-byte boundary unless ``aligned``), f32 scale and bias."""
    def draw(scale=1.0, shift=0.0):
        t = (torch.randn(rows * d + 1, generator=g, device=dev) * scale
             + shift).to(dtype)
        return (t[:-1] if aligned else t[1:]).view(rows, d)

    x, r, dy = draw(2.0, 0.5), draw(), draw()
    scale, bias = (torch.randn(d, generator=g, device=dev) for _ in range(2))
    return x, r, dy, scale, bias


def _ln_cases(torch, dev, g):
    """``(dtype name, tag, plan, x, r, dy, scale, bias)`` for every
    LayerNorm check, bf16 and f32."""
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for d, rows, aligned in (*((d, rows, True)
                                   for d, rows in LN_CHECK_WIDTHS),
                                 (1280, 512, False)):
            x, r, dy, scale, bias = _ln_inputs(torch, dev, g, rows, d, dtype,
                                               aligned)
            check(ln._aligned(x, r) == aligned, "the unaligned case is "
                  "aligned")
            plan = ln.ln_plan(d, dtype, aligned)
            check(aligned or plan.vec == 1, f"D={d} unaligned: {plan}")
            tag = f"{name} [{rows},{d}]{'' if aligned else ' unaligned'}"
            yield name, tag, plan, x, r, dy, scale, bias


def check_layernorm(torch, dev):
    """K3 against ``layernorm_plain`` at every width of
    ``LN_CHECK_WIDTHS``, bf16 and f32, with and without the residual;
    timed at [8192, 768] bf16 with and without it, eager and
    graph-replayed, beside ``F.layer_norm`` (after ``x + r``)."""
    import torch.nn.functional as F

    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln

    g = torch.Generator(device=dev).manual_seed(0)
    rec = None
    for name, tag, plan, x, r, _, scale, bias in _ln_cases(torch, dev, g):
        log(f"  layernorm {tag}: {plan}")
        for res in (None, r):
            what = f"layernorm {tag}{' +residual' if res is not None else ''}"
            err = compare(ln.fused_layernorm(x, scale, bias, 1e-5, res),
                          ln.layernorm_plain(x, scale, bias, 1e-5, res),
                          name, what)
            if name != "bfloat16" or x.shape != (8192, 768):
                continue
            kern = lambda: ln.fused_layernorm(  # noqa: E731
                x, scale, bias, 1e-5, res)
            w, b = scale.to(x.dtype), bias.to(x.dtype)
            lib = (lambda: F.layer_norm(x, (768,), w, b, 1e-5)  # noqa: E731
                   ) if res is None else (
                lambda: F.layer_norm(x + r, (768,), w, b, 1e-5))
            # x (and r) read and y written once, scale and bias read
            rows_in = 1 if res is None else 2
            nbytes = (rows_in + 1) * x.numel() * x.element_size() + 2 * 768 * 4
            bms, by = bound(nbytes, 8 * x.numel(), "float32")
            shape = ("[8192,768] bf16"
                     + ("" if res is None else " +residual"))
            got = dict(max_abs_err=err, ms=cuda_ms(kern),
                       plain_ms=cuda_ms(lambda: ln.layernorm_plain(
                           x, scale, bias, 1e-5, res)),
                       bound_ms=bms, bound_by=by, library_ms=cuda_ms(lib),
                       graph_ms=graph_ms(kern), library_graph_ms=graph_ms(lib),
                       shape=shape)
            log(f"  K3 {got['shape']}: kernel {got['ms']:.4f} ms, "
                f"graph-replayed {got['graph_ms']:.4f}; F.layer_norm"
                f"{'' if res is None else ' after x + r'} "
                f"{got['library_ms']:.4f}, graph-replayed "
                f"{got['library_graph_ms']:.4f}; plain {got['plain_ms']:.4f};"
                f" bound {bms:.4f} ({by})")
            if res is None:
                rec = got
            else:
                rec["residual"] = got
    return rec


def _flash_record(torch, fa, q, k, v, err, shape):
    """K2f, its plain version and SDPA timed on causal bf16 q/k/v, with
    the bound: q/k/v read and out written once plus the f32 lse, and
    4*D operations per unmasked (query, key) pair."""
    import torch.nn.functional as F

    b, s, h, d = q.shape
    kern = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True))
    nbytes = 4 * q.numel() * q.element_size() + b * h * s * 4
    ops = 4 * b * h * d * (s * (s + 1) / 2)
    bms, by = bound(nbytes, ops, str(q.dtype).split(".")[-1])
    return dict(max_abs_err=err, ms=cuda_ms(kern), plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=cuda_ms(lib),
                graph_ms=graph_ms(kern), library_graph_ms=graph_ms(lib),
                shape=shape)


def _flash_case(torch, fa, q, k, v, name, what, kv_mask=None, causal=True,
                segs=None):
    """K2f against its plain version: out, the finite lse, and rows with
    no unmasked key 0 with lse +inf. Returns ``(out, lse, max abs err)``."""
    out, lse = fa.flash_attention_fwd(q, k, v, kv_mask=kv_mask,
                                      causal=causal, segment_ids=segs)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, kv_mask=kv_mask,
                                            causal=causal, segment_ids=segs)
    err = compare(out, ref, name, what)
    finite = torch.isfinite(ref_lse)
    check(bool((torch.isfinite(lse) == finite).all())
          and bool(torch.isposinf(lse[~finite]).all()),
          f"{what}: lse masked rows disagree")
    empty = ~finite.transpose(1, 2)  # [B, S, H]
    check(bool((out[empty] == 0).all()), f"{what}: an empty row is not 0")
    compare(lse[finite], ref_lse[finite], "float32", f"{what} lse")
    return out, lse, err


def check_flash(torch, dev):
    """K2f against its plain version in bf16 (the tensor-core kernel) and
    f32 (the CUDA-core one): causal at B=8 S=128 and S=1024; key padding
    + segments + causal with a fully masked batch row; ragged S=200
    (causal) and S=77 (segments, with and without causal and key
    padding), which no tile divides; q/k/v as strided views of one [B, S,
    3, H, D] tensor. Then timed (bf16) at B=8 S=1024 and at the LM
    training shape B=16 S=512."""
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(1)
    rec = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for s in (128, 1024):
            q, k, v = (torch.randn(8, s, 12, 64, generator=g, device=dev
                                   ).to(dtype) for _ in range(3))
            out, _ = fa.flash_attention_fwd(q, k, v, causal=True)
            ref, _ = fa.flash_attention_plain(q, k, v, causal=True)
            err = compare(out, ref, name,
                          f"flash causal {name} B=8 S={s} H=12 D=64")
            if dtype == torch.bfloat16 and s == 1024:
                rec = _flash_record(torch, fa, q, k, v, err,
                                    "B=8 S=1024 H=12 D=64 causal bf16")
        # key padding + segments, with one fully masked row, and the lse
        q, k, v = (torch.randn(2, 256, 12, 64, generator=g, device=dev
                               ).to(dtype) for _ in range(3))
        kv_mask = torch.rand(2, 256, generator=g, device=dev) > 0.2
        kv_mask[1] = False  # batch row 1: no key at all
        segs = (torch.arange(256, device=dev) // 48).to(torch.int32)
        segs = segs[None].repeat(2, 1).contiguous()
        out, lse, _ = _flash_case(torch, fa, q, k, v, name,
                                  f"flash kv_mask+segments {name} B=2 S=256",
                                  kv_mask=kv_mask, segs=segs)
        check(bool((out[1] == 0).all()), "fully masked row is not zero")
        check(bool(torch.isposinf(lse[1]).all()),
              "fully masked row lse is not +inf")
        # ragged lengths: S = 200 causal; S = 77 with segments
        q, k, v = (torch.randn(2, 200, 12, 64, generator=g, device=dev
                               ).to(dtype) for _ in range(3))
        _flash_case(torch, fa, q, k, v, name,
                    f"flash causal {name} B=2 S=200 (ragged)")
        q, k, v = (torch.randn(3, 77, 12, 64, generator=g, device=dev
                               ).to(dtype) for _ in range(3))
        segs = (torch.arange(77, device=dev) // 20).to(torch.int32)
        segs = segs[None].repeat(3, 1).contiguous()
        kv_mask = torch.rand(3, 77, generator=g, device=dev) > 0.3
        kv_mask[2, :25] = False  # segment 0 of batch row 2: no key
        _flash_case(torch, fa, q, k, v, name,
                    f"flash segments {name} B=3 S=77 (ragged)",
                    causal=False, segs=segs)
        _flash_case(torch, fa, q, k, v, name,
                    f"flash kv_mask+segments+causal {name} B=3 S=77 "
                    "(ragged, empty rows)", kv_mask=kv_mask, segs=segs)
        # q, k, v as strided views of one fused projection [B, S, 3, H, D]
        qkv = torch.randn(2, 300, 3, 12, 64, generator=g, device=dev
                          ).to(dtype)
        q, k, v = qkv.unbind(2)
        check(not q.is_contiguous() and q.stride(-1) == 1,
              "the strided case is not strided")
        _flash_case(torch, fa, q, k, v, name,
                    f"flash causal {name} B=2 S=300, q/k/v views of [B, S, "
                    "3, H, D]")
    # the LM training shape (12 launches a step)
    q, k, v = (torch.randn(16, 512, 12, 64, generator=g, device=dev
                           ).to(torch.bfloat16) for _ in range(3))
    _, _, err = _flash_case(torch, fa, q, k, v, "bfloat16",
                            "flash causal bfloat16 B=16 S=512 H=12 D=64")
    rec["train_shape"] = _flash_record(
        torch, fa, q, k, v, err, "B=16 S=512 H=12 D=64 causal bf16")
    for r in (rec, rec["train_shape"]):
        log(f"  K2f bf16 {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}); graph-replayed: "
            f"kernel {r['graph_ms']:.4f}, SDPA {r['library_graph_ms']:.4f}")
    return rec


def check_layernorm_bwd(torch, dev):
    """K3b against ``layernorm_bwd_plain`` at every width of
    ``LN_CHECK_WIDTHS``, bf16 and f32, with and without the residual;
    timed at the training shape [8192, 768] bf16, eager and
    graph-replayed, beside ``native_layer_norm_backward``."""
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln

    g = torch.Generator(device=dev).manual_seed(5)
    rec = None
    for name, tag, _, x, r, dy, scale, _ in _ln_cases(torch, dev, g):
        for res in (None, r):
            what = (f"layernorm_bwd {tag}"
                    f"{' +residual' if res is not None else ''}")
            got = ln.layernorm_bwd(dy, x, scale, 1e-5, res)
            want = ln.layernorm_bwd_plain(dy, x, scale, 1e-5, res)
            err = compare(got[0], want[0], name, f"{what} dx")
            for i, sums in ((1, "dscale"), (2, "dbias")):
                tol = dict(atol=SUM_REL_MAX * float(want[i].abs().max()),
                           rtol=0.0, rel_l2=SUM_REL_L2)
                compare(got[i], want[i], "float32", f"{what} {sums}", tol)
            if name == "bfloat16" and x.shape == (8192, 768) and res is None:
                kern = lambda: ln.layernorm_bwd(dy, x, scale,  # noqa: E731
                                                1e-5)
                plain = cuda_ms(lambda: ln.layernorm_bwd_plain(dy, x, scale,
                                                               1e-5))
                # the library yardstick: one call computing the same
                # function, native_layer_norm_backward on the statistics
                # native_layer_norm saves (never called by the port)
                w = scale.to(x.dtype)
                b = torch.zeros_like(w)
                _, mean, rstd = torch.ops.aten.native_layer_norm(
                    x, [768], w, b, 1e-5)
                native = lambda: torch.ops.aten.native_layer_norm_backward(  # noqa: E731,E501
                    dy, x, [768], mean, rstd, w, b, [True, True, True])
                lib = cuda_ms(native)
                # x and dy read, dx written, scale read, dscale and dbias
                # written; ~17 f32 operations per element (statistics,
                # closed form, column sums)
                nbytes = 3 * x.numel() * x.element_size() + 3 * 768 * 4
                bms, by = bound(nbytes, 17 * x.numel(), "float32")
                rec = dict(max_abs_err=err, ms=cuda_ms(kern), plain_ms=plain,
                           bound_ms=bms, bound_by=by, library_ms=lib,
                           graph_ms=graph_ms(kern),
                           library_graph_ms=graph_ms(native),
                           shape="[8192,768] bf16")
                log(f"  K3b [8192,768] bf16: kernel {rec['ms']:.4f} ms, "
                    f"graph-replayed {rec['graph_ms']:.4f}; "
                    f"native_layer_norm_backward {lib:.4f}, graph-replayed "
                    f"{rec['library_graph_ms']:.4f}; bound {bms:.4f} ({by})")
    return rec


def _flash_bwd_case(torch, dev, g, dtype, case, b=16, s=512, h=12, d=64):
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=dev
                                 ).to(dtype) for _ in range(4))
    kv_mask = segs = None
    if case in ("segments", "masked"):
        # documents of 100 tokens, as packed rows carry them
        segs = (torch.arange(s, device=dev) // 100).to(torch.int32)
        segs = segs[None].repeat(b, 1).contiguous()
    if case == "masked":
        kv_mask = torch.rand(b, s, generator=g, device=dev) > 0.1
        kv_mask[:, _empty_row(s)] = False
        kv_mask[_masked_batch(b)] = False  # no key at all
    return q, k, v, dout, kv_mask, segs


def _empty_row(s: int) -> int:
    """A query row that starts a 100-token document, so that under the
    causal mask it sees only its own key: with that key padded it is
    empty (200 at S = 512)."""
    return min(200, (s - 1) // 100 * 100)


def _masked_batch(b: int) -> int:
    return min(3, b - 1)


def _flash_bwd_check(torch, fa, name, tag, q, k, v, dout, kv_mask, segs):
    """K2f's out and lse against the plain version, then K2dq and K2dkv
    against ``flash_attention_bwd_plain`` on the same inputs (q, k, v, dO
    and the forward kernel's out and lse). Returns the errors of dq, dk,
    dv and the backward's inputs."""
    out, lse = fa.flash_attention_fwd(q, k, v, kv_mask, True, segs)
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, kv_mask, True, segs)
    compare(out, ref_out, name, f"flash fwd {tag} out")
    finite = torch.isfinite(ref_lse)
    check(bool((torch.isfinite(lse) == finite).all()),
          f"flash fwd {tag}: lse masked rows disagree")
    compare(lse[finite], ref_lse[finite], "float32", f"flash fwd {tag} lse")
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_dq(dout, q, k, v, lse, delta, kv_mask, True, segs)
    dk, dv = fa.flash_attention_dkv(dout, q, k, v, lse, delta, kv_mask, True,
                                    segs)
    ref = fa.flash_attention_bwd_plain(q, k, v, dout, lse, delta, kv_mask,
                                       True, segs)
    errs = tuple(compare(got, want, name, f"flash bwd {tag} {what}")
                 for got, want, what in zip((dq, dk, dv), ref,
                                            ("dq", "dk", "dv")))
    if kv_mask is not None:
        row = _masked_batch(q.shape[0])
        check(bool((dq[row] == 0).all() and (dk[row] == 0).all()
                   and (dv[row] == 0).all()),
              f"flash bwd {tag}: fully masked batch row has a gradient")
        check(bool((dq[:, _empty_row(q.shape[1])] == 0).all()),
              f"flash bwd {tag}: the empty query row has a gradient")
    return errs, lse, delta


def check_flash_bwd(torch, dev):
    """At the training shape B=16 S=512 H=12 D=64 (causal; causal +
    segments; key padding + segments + causal with an empty row and a
    fully masked batch row) and at ragged S = 200 and 77 (the same three
    masks; q/k/v as views of one [B, S, 3, H, D] tensor and an expanded
    dO at S = 200): K2f's out and lse, then K2dq and K2dkv against
    ``flash_attention_bwd_plain``, in bf16 (K2dkv: the tensor-core
    kernel) and f32. Then timed at the training shape, eager and
    replayed from a CUDA graph, beside the plain version and the SDPA
    backward (which computes dQ, dK and dV together) on today's [B, S, H,
    D] views and on contiguous [B, H, S, D] tensors."""
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(6)
    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for s in (512, 200, 77):
            for case in ("causal", "segments", "masked"):
                q, k, v, dout, kv_mask, segs = _flash_bwd_case(
                    torch, dev, g, dtype, case, b=16 if s == 512 else 3, s=s)
                tag = f"{case} {name} B={q.shape[0]} S={s} H=12 D=64"
                if s == 200 and case == "masked":
                    # q/k/v as strided views of one fused projection, and
                    # a cotangent expanded over the heads
                    qkv = torch.randn(3, s, 3, 12, 64, generator=g,
                                      device=dev).to(dtype)
                    q, k, v = qkv.unbind(2)
                    dout = dout[:, :, :1].expand(-1, -1, 12, -1)
                    check(not q.is_contiguous() and dout.stride(2) == 0,
                          "the strided case is not strided")
                    tag += ", q/k/v views of [B, S, 3, H, D], dO expanded"
                errs, lse, delta = _flash_bwd_check(
                    torch, fa, name, tag, q, k, v, dout, kv_mask, segs)
                if dtype == torch.bfloat16 and s == 512 and case == "causal":
                    recs = _flash_bwd_record(torch, fa, q, k, v, dout, lse,
                                             delta, errs)
    return recs


def _flash_bwd_record(torch, fa, q, k, v, dout, lse, delta, errs):
    """K2dq and K2dkv at a causal shape (the bf16 training shape, and
    phase 3's other head widths), eager and graph-replayed, beside the
    plain version and the SDPA backward."""
    import torch.nn.functional as F

    b, s, h, d = q.shape
    name = str(q.dtype).split(".")[-1]
    shape = f"B={b} S={s} H={h} D={d} causal {name.replace('bfloat16', 'bf16')}"
    plain = cuda_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, dout, lse, delta, causal=True))
    lib, lib_graph, lib_c, lib_c_graph = _sdpa_bwd_times(torch, F, q, k, v,
                                                         dout)
    log(f"  SDPA backward (dQ + dK + dV) {shape}: "
        f"[B, S, H, D] views {lib:.4f} ms, graph-replayed {lib_graph}; "
        f"contiguous [B, H, S, D] {lib_c:.4f}, graph-replayed "
        f"{lib_c_graph}")
    pairs = b * h * s * (s + 1) / 2  # causal (query, key) pairs
    row = q.numel() * q.element_size()  # one [B, S, H, D] tensor
    vecs = 2 * b * h * s * 4  # lse and delta
    libs = dict(library_ms=lib, library_graph_ms=lib_graph,
                library_contiguous_ms=lib_c,
                library_contiguous_graph_ms=lib_c_graph)
    dq_fn = lambda: fa.flash_attention_dq(  # noqa: E731
        dout, q, k, v, lse, delta, causal=True)
    dkv_fn = lambda: fa.flash_attention_dkv(  # noqa: E731
        dout, q, k, v, lse, delta, causal=True)
    # K2dq reads q, k, v, dO, lse, delta and writes dq; s, dp and the dq
    # update are 3 products of D per pair. K2dkv writes dk and dv; s, dp,
    # dv and dk are 4 products of D per pair.
    recs = {}
    for key, fn, nbytes, ops, err in (
            ("flash_attention_dq", dq_fn, 5 * row + vecs, 6 * d * pairs,
             errs[0]),
            ("flash_attention_dkv", dkv_fn, 6 * row + vecs, 8 * d * pairs,
             max(errs[1], errs[2]))):
        bms, by = bound(nbytes, ops, name)
        recs[key] = dict(max_abs_err=err, ms=cuda_ms(fn), plain_ms=plain,
                         bound_ms=bms, bound_by=by, graph_ms=graph_ms(fn),
                         shape=shape, **libs)
        r = recs[key]
        log(f"  {key} {shape}: kernel {r['ms']:.4f} ms, graph-replayed "
            f"{r['graph_ms']:.4f}, plain {plain:.4f}, bound {bms:.4f} ({by})")
    return recs


def _sdpa_bwd_times(torch, F, q, k, v, dout, causal=True):
    """The SDPA backward (dQ, dK and dV together), eager and
    graph-replayed, on transposed [B, S, H, D] views and on contiguous
    [B, H, S, D] copies. Graph-replayed: forward and backward captured
    together, less the forward alone; autograd's backward syncs with the
    stream its leaves were made on, so the captured function makes its
    own leaves (views of the inputs). A capture that fails leaves that
    time None ("not measured") and is logged: it is a yardstick, not a
    kernel of the port."""
    times = []
    for contiguous in (False, True):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        dt = dout.transpose(1, 2)
        if contiguous:
            qt, kt, vt, dt = (t.contiguous() for t in (qt, kt, vt, dt))
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        y = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        eager = cuda_ms(lambda: torch.autograd.grad(
            y, leaves, dt, retain_graph=True))

        def fwd():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        def fwd_bwd():
            own = [t.detach().requires_grad_() for t in (qt, kt, vt)]
            torch.autograd.grad(F.scaled_dot_product_attention(
                *own, is_causal=causal), own, dt)

        try:
            graphed = max(graph_ms(fwd_bwd) - graph_ms(fwd), 0.0)
        except RuntimeError as exc:  # torch.AcceleratorError included
            log(f"  SDPA backward graph capture failed, not measured: "
                f"{str(exc).splitlines()[0]}")
            torch.cuda.synchronize()
            graphed = None
        times += [eager, graphed]
    return times


# Head widths beside GPT-small's 64 that phase 3 holds K2f, K2dq and
# K2dkv at, with the design flash_plan must pick for each dtype: 128 (a
# Llama-width head: bf16 on the tensor cores, f32 on the CUDA cores) and
# 32 and 80 (CUDA-core widths: 32 is instantiated, 80 runs the 128-wide
# instantiation with its loads masked). Each is timed (bf16) at B=16
# S=512 H=8, a training batch of the LM's sequence length.
FLASH_WIDTHS = ((128, {"bfloat16": "wgmma", "float32": "simt"}),
                (32, {"bfloat16": "simt", "float32": "simt"}),
                (80, {"bfloat16": "simt", "float32": "simt"}))
FLASH_TIMED_WIDTHS = (128, 80)


def check_flash_widths(torch, dev):
    """K2f, K2dq and K2dkv at head widths 128, 32 and 80 in bf16 and f32
    against their plain versions: causal at B=2 S=200 H=4 (ragged), key
    padding + segments + causal with an empty row and a fully masked
    batch row at B=3 S=77, and q/k/v as views of one [B, S, 3, H, D]
    tensor with a cotangent expanded over the heads; each call's launch
    counter must move and flash_plan must pick the expected design. Then
    the bf16 kernels at D 128 (tensor cores) and D 80 (CUDA cores) are
    timed at B=16 S=512 H=8, eager and graph-replayed, beside their bound,
    the plain versions and SDPA forward and backward. Returns ``{kernel:
    {"d128": record, "d80": record}}``."""
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(16)
    recs = {"flash_attention_fwd": {}, "flash_attention_dq": {},
            "flash_attention_dkv": {}}
    for d, designs in FLASH_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            plan = fa.flash_plan(d, dtype)
            check(plan.design == designs[name],
                  f"flash_plan({d}, {name}) = {plan}, expected the "
                  f"{designs[name]} design")
            log(f"  flash D={d} {name}: plan {plan.design} at width "
                f"{plan.width}")
            for b, s, case in ((2, 200, "causal"), (3, 77, "masked"),
                               (3, 77, "views")):
                q, k, v, dout, kv_mask, segs = _flash_bwd_case(
                    torch, dev, g, dtype, "causal" if case == "views"
                    else case, b=b, s=s, h=4, d=d)
                tag = f"{case} {name} B={b} S={s} H=4 D={d}"
                if case == "views":
                    qkv = torch.randn(b, s, 3, 4, d, generator=g,
                                      device=dev).to(dtype)
                    q, k, v = qkv.unbind(2)
                    dout = dout[:, :, :1].expand(-1, -1, 4, -1)
                before = (fa.launches, fa.dq_launches, fa.dkv_launches)
                _flash_bwd_check(torch, fa, name, tag, q, k, v, dout,
                                 kv_mask, segs)
                check((fa.launches, fa.dq_launches, fa.dkv_launches)
                      == tuple(n + 1 for n in before),
                      f"flash {tag}: a kernel was not launched")
    for d in FLASH_TIMED_WIDTHS:
        for key, rec in time_flash_width(torch, dev, g, d).items():
            recs[key][f"d{d}"] = rec
    return recs


def time_flash_width(torch, dev, g, d, b=16, s=512, h=8, dtype=None):
    """K2f, K2dq and K2dkv at head width ``d`` (bf16 unless ``dtype``;
    causal, B=16 S=512 H=8 by default), checked against their plain
    versions, then timed eager and graph-replayed beside their bound, the
    plain versions and SDPA forward and backward. Returns ``{kernel:
    record}``."""
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    dtype = dtype or torch.bfloat16
    name = str(dtype).split(".")[-1]
    q, k, v, dout, _, _ = _flash_bwd_case(
        torch, dev, g, dtype, "causal", b=b, s=s, h=h, d=d)
    errs, lse, delta = _flash_bwd_check(
        torch, fa, name, f"causal {name} B={b} S={s} H={h} D={d}",
        q, k, v, dout, None, None)
    out = fa.flash_attention_fwd(q, k, v, causal=True)[0]
    err = float((out.float() - fa.flash_attention_plain(
        q, k, v, causal=True)[0].float()).abs().max())
    fwd = _flash_record(torch, fa, q, k, v, err,
                        f"B={b} S={s} H={h} D={d} causal {name}")
    log(f"  K2f {name} {fwd['shape']} ({fa.flash_plan(d, q.dtype).design}"
        f"): kernel {fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.4f}, "
        f"SDPA {fwd['library_ms']:.4f}, bound {fwd['bound_ms']:.4f} "
        f"({fwd['bound_by']}); graph-replayed: kernel "
        f"{fwd['graph_ms']:.4f}, SDPA {fwd['library_graph_ms']:.4f}")
    return {"flash_attention_fwd": fwd,
            **_flash_bwd_record(torch, fa, q, k, v, dout, lse, delta, errs)}


# ResNet-50's 36 fused 1x1 convs at batch 64 (224^2), as (M, K, N,
# transform, count): M rows of NHWC pixels, K input and N output
# channels, "relu" where the conv reads relu(norm(x)) (conv3), and how
# many of the 36 calls of one forward have the shape
RESNET50_K4_SHAPES = (
    (200704, 64, 64, None, 1), (200704, 64, 256, "relu", 3),
    (200704, 64, 256, None, 1), (200704, 256, 64, None, 2),
    (200704, 256, 128, None, 1), (50176, 128, 512, "relu", 4),
    (50176, 256, 512, None, 1), (50176, 512, 128, None, 3),
    (50176, 512, 256, None, 1), (12544, 256, 1024, "relu", 6),
    (12544, 512, 1024, None, 1), (12544, 1024, 256, None, 5),
    (12544, 1024, 512, None, 1), (3136, 512, 2048, "relu", 3),
    (3136, 1024, 2048, None, 1), (3136, 2048, 512, None, 2))
# the shapes held against the plain versions (bf16 and f32): two of
# stage 1, one of stage 3, one of stage 4, a ragged one with the affine
# transform and no relu, and one whose K and N are not multiples of 8
# (the masked edge path of the bf16 kernels)
K4_CHECK_SHAPES = ((200704, 256, 64, None), (200704, 64, 256, "relu"),
                   (12544, 1024, 256, None), (3136, 512, 2048, "relu"),
                   (1000, 72, 40, "affine"), (1000, 12, 20, "relu"))


def _k4_tol(ref, dtype_name: str, over_m: bool = False):
    """K4 outputs against the plain versions: both sum the same f32
    products in another order, then round once to the output type, so a
    bf16 output may sit one rounding (2^-7 relative) apart, and the
    whole tensor within 1e-3 relative L2 (a few such roundings); f32
    within 1e-5 relative, element and L2, for sums over K or N (<= 2048
    terms), and 1e-4 for dw's sums over M (up to 200,704 terms: f32
    rounding of a sum of n zero-mean terms grows as sqrt(n) eps, 2.7e-5
    at that n). Near-zero outputs (cancellation) get an absolute slack of
    1e-4 (bf16) or 1e-5 (f32) of the largest reference element."""
    top = float(ref.abs().max())
    if dtype_name == "bfloat16":
        return dict(atol=1e-4 * top, rtol=2.0 ** -7, rel_l2=1e-3)
    rel = 1e-4 if over_m else 1e-5
    return dict(atol=1e-5 * top, rtol=rel, rel_l2=rel)


def _sum_tol(ref):
    """f32 column sums over up to 200,704 rows in another order."""
    return dict(atol=SUM_REL_MAX * float(ref.abs().max()), rtol=0.0,
                rel_l2=SUM_REL_L2)


def _k4_inputs(torch, dev, g, m, k, n, dtype, transform):
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = (torch.randn(k, n, generator=g, device=dev) / math.sqrt(k)).to(dtype)
    dy = torch.randn(m, n, generator=g, device=dev).to(dtype)
    a = b = None
    if transform is not None:
        a = torch.rand(k, generator=g, device=dev) + 0.5
        b = torch.randn(k, generator=g, device=dev) * 0.5
    return x, w, dy, a, b


def check_fused_matmul(torch, dev):
    """K4f, K4dx and K4dw against their plain versions at ResNet-50's
    shapes in bf16 and f32; then each kernel, its plain version and a
    ``torch.matmul`` of the same product (cuBLAS, operands prepared
    outside the timed region: no transform, mask or statistics) timed
    on all 16 distinct shapes of a step, summed over its 36 calls,
    eager and replayed from a CUDA graph (the bf16 kernels are all on
    the tensor cores)."""
    from pyspark_tf_gke_tpu_torch.ops import fused_matmul as fm

    g = torch.Generator(device=dev).manual_seed(8)
    errs = {"fused_matmul_fwd": 0.0, "fused_matmul_dx": 0.0,
            "fused_matmul_dw": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for m, k, n, transform in K4_CHECK_SHAPES:
            x, w, dy, a, b = _k4_inputs(torch, dev, g, m, k, n, dtype,
                                        transform)
            relu = transform == "relu"
            tag = f"k4 {name} M={m} K={k} N={n} {transform or 'plain'}"
            y, st = fm.norm_relu_matmul_fwd(x, w, a, b, relu, True)
            ry, rs, rss = fm.norm_relu_matmul_plain(x, w, a, b, relu=relu,
                                                    want_stats=True)
            rst = torch.stack([rs, rss])
            errs["fused_matmul_fwd"] = max(errs["fused_matmul_fwd"], compare(
                y, ry, name, f"{tag} K4f y", _k4_tol(ry, name)))
            compare(st, rst, "float32", f"{tag} K4f stats", _sum_tol(rst))
            y0, st0 = fm.norm_relu_matmul_fwd(x, w, a, b, relu, False)
            check(st0 is None and torch.equal(y0, y),
                  f"{tag}: K4f without statistics differs")
            dx, ds = fm.norm_relu_matmul_dx(dy, w, x, a, b, relu)
            rdx, rds = fm.norm_relu_matmul_dx_plain(dy, w, x, a, b, relu)
            errs["fused_matmul_dx"] = max(errs["fused_matmul_dx"], compare(
                dx, rdx, name, f"{tag} K4dx dx", _k4_tol(rdx, name)))
            if a is not None:
                compare(ds, rds, "float32", f"{tag} K4dx da/db", _sum_tol(rds))
            dw = fm.norm_relu_matmul_dw(x, dy, a, b, relu)
            rdw = fm.norm_relu_matmul_dw_plain(x, dy, a, b, relu)
            errs["fused_matmul_dw"] = max(errs["fused_matmul_dw"], compare(
                dw, rdw, name, f"{tag} K4dw dw",
                _k4_tol(rdw, name, over_m=True)))
            del x, w, dy, y, ry, dx, rdx, dw, rdw
        torch.cuda.empty_cache()

    totals = {key: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                        ops_ms=0.0, bytes_ms=0.0) for key in errs}
    # each kernel and its matmul also graph-replayed
    graphed = {key: dict(graph_ms=0.0, library_graph_ms=0.0) for key in errs}
    for m, k, n, transform, count in RESNET50_K4_SHAPES:
        x, w, dy, a, b = _k4_inputs(torch, dev, g, m, k, n, torch.bfloat16,
                                    transform)
        relu = transform == "relu"
        xn = x if a is None else torch.relu(x.float() * a + b).to(x.dtype)
        wt = w.t().contiguous()
        xnt = xn.t().contiguous()
        s = 2  # bytes per bf16 element
        ops = 2.0 * m * k * n
        vec = 2 * k * 4 if a is not None else 0  # a and b
        work = {
            # reads x, w (a, b); writes y and the [2, N] statistics
            "fused_matmul_fwd": (
                lambda: fm.norm_relu_matmul_fwd(x, w, a, b, relu, True),
                lambda: fm.norm_relu_matmul_plain(x, w, a, b, relu=relu,
                                                  want_stats=True),
                lambda: torch.matmul(xn, w),
                (m * k + k * n + m * n) * s + vec + 2 * n * 4),
            # reads dy, w (and x, a, b with a transform); writes dx (and
            # the [2, K] d a, d b)
            "fused_matmul_dx": (
                lambda: fm.norm_relu_matmul_dx(dy, w, x, a, b, relu),
                lambda: fm.norm_relu_matmul_dx_plain(dy, w, x, a, b, relu),
                lambda: torch.matmul(dy, wt),
                (m * n + k * n + m * k) * s
                + (m * k * s + vec + 2 * k * 4 if a is not None else 0)),
            # reads x, dy (a, b); writes dw
            "fused_matmul_dw": (
                lambda: fm.norm_relu_matmul_dw(x, dy, a, b, relu),
                lambda: fm.norm_relu_matmul_dw_plain(x, dy, a, b, relu),
                lambda: torch.matmul(xnt, dy),
                (m * k + m * n + k * n) * s + vec),
        }
        line = []
        for key, (kern, plain, lib, nbytes) in work.items():
            ms = cuda_ms(kern, warmup=1, iters=3, reps=3)
            pms = cuda_ms(plain, warmup=1, iters=2, reps=3)
            lms = cuda_ms(lib, warmup=1, iters=3, reps=3)
            bms, _ = bound(nbytes, ops, "bfloat16")
            tot = totals[key]
            tot["ms"] += count * ms
            tot["plain_ms"] += count * pms
            tot["library_ms"] += count * lms
            tot["bound_ms"] += count * bms
            tot["bytes_ms"] += count * nbytes / HBM_BYTES_PER_S * 1e3
            tot["ops_ms"] += count * ops / PEAK_OPS["bfloat16"] * 1e3
            gms, glms = graph_ms(kern, 5), graph_ms(lib, 5)
            graphed[key]["graph_ms"] += count * gms
            graphed[key]["library_graph_ms"] += count * glms
            line.append(f"{key[13:]} {ms:.4f}/{pms:.4f}/{lms:.4f}/{bms:.4f} "
                        f"graph-replayed {gms:.4f}/{glms:.4f}")
        log(f"  k4 bf16 M={m} K={k} N={n} {transform or 'plain'} x{count} "
            f"(kernel/plain/matmul/bound ms): {', '.join(line)}")
        del x, w, dy, xn, wt, xnt
    torch.cuda.empty_cache()
    recs = {}
    for key, tot in totals.items():
        recs[key] = dict(
            max_abs_err=errs[key], ms=tot["ms"], plain_ms=tot["plain_ms"],
            library_ms=tot["library_ms"], bound_ms=tot["bound_ms"],
            bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                      else "operations"),
            shape="the 36 calls of one ResNet-50 step, batch 64, bf16 "
                  "(summed)")
    for key, times in graphed.items():
        recs[key].update(times)
    return recs


# ResNet-50's 13 stride-1 3x3 convs at batch 64 (224^2), as (B, H, W,
# K = N, count): the input [B, H, W, K] of conv2 in the stride-1 blocks
# of each stage, and how many of the 13 calls of one forward have it
RESNET50_K5_SHAPES = ((64, 56, 56, 64, 3), (64, 28, 28, 128, 3),
                      (64, 14, 14, 256, 5), (64, 7, 7, 512, 2))
# the shapes held against the plain versions (bf16 and f32): the four
# stages, with and without the transform, and a ragged one (H, W not
# multiples of anything, K and N not multiples of the 16 / 64 tiles,
# tiles of 128 pixels crossing rows and images) in all three modes, and
# one whose K and N are not multiples of 8 (bf16 K5f's masked edge path)
K5_CHECK_SHAPES = tuple((b, h, w, k, k, t) for b, h, w, k, _ in
                        RESNET50_K5_SHAPES for t in ("relu", None)) + tuple(
    (3, 9, 5, 48, 80, t) for t in ("relu", "affine", None)) + (
    (2, 6, 7, 12, 20, "relu"),)


def _k5_tol(ref, dtype_name: str, over_m: bool = False):
    """K5 outputs against the plain versions: as :func:`_k4_tol`, but the
    f32 sums of y and dx run over 9 x K terms (up to 4,608; f32 rounding
    of such a sum grows as sqrt(n) eps, 4e-6 at that n): 2e-5 relative.
    dw's sums over the pixels (up to 200,704 terms a tap) keep 1e-4."""
    if dtype_name == "bfloat16" or over_m:
        return _k4_tol(ref, dtype_name, over_m)
    return dict(atol=1e-5 * float(ref.abs().max()), rtol=2e-5, rel_l2=2e-5)


def _k5_inputs(torch, dev, g, b, h, w, k, n, dtype, transform):
    x = torch.randn(b, h, w, k, generator=g, device=dev).to(dtype)
    wt = (torch.randn(3, 3, k, n, generator=g, device=dev)
          / math.sqrt(9 * k)).to(dtype)
    dy = torch.randn(b, h, w, n, generator=g, device=dev).to(dtype)
    a = bb = None
    if transform is not None:
        a = torch.rand(k, generator=g, device=dev) + 0.5
        bb = torch.randn(k, generator=g, device=dev) * 0.5
    return x, wt, dy, a, bb


def check_fused_conv3(torch, dev):
    """K5f, K5dx and K5dw against their plain versions at ResNet-50's
    stride-1 3x3 shapes and a ragged one, in bf16 and f32, with and
    without the transform and the statistics; then each kernel, its plain
    version and a cuDNN yardstick (bf16, channels-last: ``F.conv2d`` on
    the materialised ``relu(x*a+b)``, and the conv's ``conv2d_input`` and
    ``conv2d_weight`` gradients; operands prepared outside the timed
    region) timed at the four stage shapes, summed over the 13 calls of
    one step."""
    import torch.nn.functional as F
    from torch.nn import grad as conv_grad

    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc

    g = torch.Generator(device=dev).manual_seed(9)
    errs = {"fused_conv3_fwd": 0.0, "fused_conv3_dx": 0.0,
            "fused_conv3_dw": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, h, w, k, n, transform in K5_CHECK_SHAPES:
            x, wt, dy, a, bb = _k5_inputs(torch, dev, g, b, h, w, k, n, dtype,
                                          transform)
            relu = transform == "relu"
            tag = (f"k5 {name} x=[{b},{h},{w},{k}] N={n} "
                   f"{transform or 'plain'}")
            y, st = fc.conv3_fwd(x, wt, a, bb, relu, True)
            ry, rst = fc.conv3_fwd_plain(x, wt, a, bb, relu, True)
            errs["fused_conv3_fwd"] = max(errs["fused_conv3_fwd"], compare(
                y, ry, name, f"{tag} K5f y", _k5_tol(ry, name)))
            compare(st, rst, "float32", f"{tag} K5f stats", _sum_tol(rst))
            y0, st0 = fc.conv3_fwd(x, wt, a, bb, relu, False)
            check(st0 is None and torch.equal(y0, y),
                  f"{tag}: K5f without statistics differs")
            dx, ds = fc.conv3_dx(dy, wt, x, a, bb, relu)
            rdx, rds = fc.conv3_dx_plain(dy, wt, x, a, bb, relu)
            errs["fused_conv3_dx"] = max(errs["fused_conv3_dx"], compare(
                dx, rdx, name, f"{tag} K5dx dx", _k5_tol(rdx, name)))
            check((ds is None) == (a is None), f"{tag}: K5dx d a / d b")
            if a is not None:
                compare(ds, rds, "float32", f"{tag} K5dx da/db", _sum_tol(rds))
            dw = fc.conv3_dw(x, dy, a, bb, relu)
            rdw = fc.conv3_dw_plain(x, dy, a, bb, relu)
            errs["fused_conv3_dw"] = max(errs["fused_conv3_dw"], compare(
                dw, rdw, name, f"{tag} K5dw dw",
                _k5_tol(rdw, name, over_m=True)))
            del x, wt, dy, y, ry, y0, dx, rdx, dw, rdw
        torch.cuda.empty_cache()

    totals = {key: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                        ops_ms=0.0, bytes_ms=0.0) for key in errs}
    # each kernel (the bf16 ones are the tensor-core kernels) and cuDNN
    # also graph-replayed
    graphed = {key: dict(graph_ms=0.0, library_graph_ms=0.0)
               for key in ("fused_conv3_fwd", "fused_conv3_dx",
                           "fused_conv3_dw")}
    for b, h, w, k, count in RESNET50_K5_SHAPES:
        n = k
        x, wt, dy, a, bb = _k5_inputs(torch, dev, g, b, h, w, k, n,
                                      torch.bfloat16, "relu")
        xn = torch.relu(x.float() * a + bb).to(x.dtype)
        # channels-last NCHW views of the NHWC tensors, OIHW weights
        xn_c, x_c, dy_c = (t.permute(0, 3, 1, 2) for t in (xn, x, dy))
        w_c = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        m, s = b * h * w, 2  # pixels, bytes per bf16 element
        ops = 2.0 * m * 9 * k * n
        vec = 2 * k * 4  # a and b
        work = {
            # reads x, w, a, b; writes y and the [2, N] statistics
            "fused_conv3_fwd": (
                lambda: fc.conv3_fwd(x, wt, a, bb, True, True),
                lambda: fc.conv3_fwd_plain(x, wt, a, bb, True, True),
                lambda: F.conv2d(xn_c, w_c, padding=1),
                (m * k + 9 * k * n + m * n) * s + vec + 2 * n * 4),
            # reads dy, w, x, a, b; writes dx and the [2, K] d a, d b
            "fused_conv3_dx": (
                lambda: fc.conv3_dx(dy, wt, x, a, bb, True),
                lambda: fc.conv3_dx_plain(dy, wt, x, a, bb, True),
                lambda: conv_grad.conv2d_input(x_c.shape, w_c, dy_c,
                                               padding=1),
                (m * n + 9 * k * n + 2 * m * k) * s + vec + 2 * k * 4),
            # reads x, dy, a, b; writes dw
            "fused_conv3_dw": (
                lambda: fc.conv3_dw(x, dy, a, bb, True),
                lambda: fc.conv3_dw_plain(x, dy, a, bb, True),
                lambda: conv_grad.conv2d_weight(xn_c, w_c.shape, dy_c,
                                                padding=1),
                (m * k + m * n + 9 * k * n) * s + vec),
        }
        line = []
        for key, (kern, plain, lib, nbytes) in work.items():
            ms = cuda_ms(kern, warmup=1, iters=3, reps=3)
            pms = cuda_ms(plain, warmup=1, iters=2, reps=3)
            lms = cuda_ms(lib, warmup=1, iters=3, reps=3)
            bms, _ = bound(nbytes, ops, "bfloat16")
            tot = totals[key]
            tot["ms"] += count * ms
            tot["plain_ms"] += count * pms
            tot["library_ms"] += count * lms
            tot["bound_ms"] += count * bms
            tot["bytes_ms"] += count * nbytes / HBM_BYTES_PER_S * 1e3
            tot["ops_ms"] += count * ops / PEAK_OPS["bfloat16"] * 1e3
            line.append(f"{key[12:]} {ms:.4f}/{pms:.4f}/{lms:.4f}/{bms:.4f}")
            if key in graphed:
                gms, glms = graph_ms(kern, 5), graph_ms(lib, 5)
                graphed[key]["graph_ms"] += count * gms
                graphed[key]["library_graph_ms"] += count * glms
                line.append(f"{key[12:]} graph-replayed {gms:.4f}/{glms:.4f}")
        log(f"  k5 bf16 x=[{b},{h},{w},{k}] N={n} relu x{count} "
            f"(kernel/plain/cudnn/bound ms): {', '.join(line)}")
        del x, wt, dy, xn, xn_c, x_c, dy_c, w_c
    torch.cuda.empty_cache()
    recs = {}
    for key, tot in totals.items():
        recs[key] = dict(
            max_abs_err=errs[key], ms=tot["ms"], plain_ms=tot["plain_ms"],
            library_ms=tot["library_ms"], bound_ms=tot["bound_ms"],
            bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                      else "operations"),
            shape="the 13 calls of one ResNet-50 step, batch 64, bf16 "
                  "(summed)")
    for key, times in graphed.items():
        recs[key].update(times)
    return recs


# K1's checked cases (H_kv, S, int8 pages, fills) at H = 12, 8 slots of
# 16 pages of 64 tokens: decode (S = 1) and verify-sized chunks (S = 8),
# the decode variant; S = 256 (a chunked-prefill piece of GPT-small: R =
# 256 rows, two 128-row blocks) and S = 512 at 12/4 GQA (R = 1536), the
# chunk variant for a bf16 query and the first design for f32; S = 256
# with every fill <= 128, so that the first row block of every slot sees
# no key and must give zeros; the serving decode shape (every slot at
# 716, the phase-4 prompts after 16 steps); and fills on the decode
# variant's split boundaries (SPLIT_FILLS: a split's last entry, one
# past it, the table's end)
PAGED_FILLS = (0, 1, 63, 64, 65, 500, 960, 1024)
SERVE_FILLS = (716,) * 8
SPLIT_FILLS = "split"
PAGED_CASES = ((12, 1, False, PAGED_FILLS), (4, 1, False, PAGED_FILLS),
               (12, 1, True, PAGED_FILLS), (4, 8, True, PAGED_FILLS),
               (12, 8, False, PAGED_FILLS), (12, 256, False, PAGED_FILLS),
               (12, 256, True, PAGED_FILLS), (4, 512, False, PAGED_FILLS),
               (4, 512, True, PAGED_FILLS),
               (12, 256, False, (0, 1, 63, 64, 100, 127, 128, 128)),
               (12, 1, False, SERVE_FILLS), (12, 1, True, SERVE_FILLS),
               (12, 1, False, SPLIT_FILLS), (12, 1, True, SPLIT_FILLS),
               (4, 8, False, SPLIT_FILLS), (12, 4, False, PAGED_FILLS),
               (4, 2, True, PAGED_FILLS), (12, 6, False, SERVE_FILLS))


def _split_fills(torch, pa, hkv, s, h=12):
    """Fills on the decode variant's split boundaries at this shape (8
    slots, H = ``h``, 16 pages of 64 tokens; the split does not depend on
    the dtypes, and a bf16 S past ``DECODE_MAX_S`` runs them through the
    chunk variant): empty, a split's entries full (pages_per_split x P) and
    one token past them, two splits less one token, every entry (MP x
    P), and three others."""
    plan = pa.paged_plan(8, s, h, hkv, 64, 64, 16, torch.bfloat16,
                         torch.bfloat16, variant="decode")
    edge = plan.pages_per_split * 64
    return (0, edge, edge + 1, 2 * edge - 1, 1024, 65, 700, s)


def _paged_case(torch, dev, g, dtype, hkv, s, quant, fills=PAGED_FILLS,
                h=12, d=64):
    n, p, mp = 128, 64, 16
    fills = torch.tensor(fills, dtype=torch.int32, device=dev)
    b = fills.numel()
    table = torch.full((b, mp), n, dtype=torch.int32)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(2))
    used = 0
    for row, fill in enumerate(fills.tolist()):
        live = -(-fill // p)
        table[row, :live] = perm[used:used + live]
        used += live
    table[5, 3] = n  # a sentinel inside a live range: clamped, as the
    #                  reference clamps it
    table = table.to(dev)
    if quant:
        kp = torch.randint(-127, 128, (n, p, hkv, d), generator=g,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (n, p, hkv, d), generator=g,
                           device=dev, dtype=torch.int8)
        ks = torch.rand(n, p, hkv, generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand(n, p, hkv, generator=g, device=dev) * 0.02 + 1e-3
    else:
        kp, vp = (torch.randn(n, p, hkv, d, generator=g, device=dev
                              ).to(dtype) for _ in range(2))
        ks = vs = None
    q = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
    return q, kp, vp, table, fills, ks, vs


def _paged_record(torch, pa, q, kp, vp, table, fills, err, shape):
    """Times of bf16 K1 and of SDPA over the gathered pages, eager and
    graph-replayed, and the bound, at one shape."""
    kern = lambda: pa.paged_attention_chunk(q, kp, vp, table,  # noqa: E731
                                            fills)
    lib = lambda: _sdpa_over_gathered(torch, q, kp, vp, table,  # noqa: E731
                                      fills)
    bms, by = _paged_bound(q, kp, table, fills)
    return dict(max_abs_err=err, ms=cuda_ms(kern), graph_ms=graph_ms(kern),
                plain_ms=cuda_ms(lambda: pa.paged_attention_chunk_plain(
                    q, kp, vp, table, fills), iters=3, reps=3),
                library_ms=cuda_ms(lib), library_graph_ms=graph_ms(lib),
                bound_ms=bms, bound_by=by, shape=shape)


def check_paged(torch, dev):
    """K1 against ``paged_attention_chunk_plain`` in every case of
    ``PAGED_CASES``, bf16 and f32 (a query with no key, and the empty
    slot, exactly zero), each call's variant the one ``paged_plan``
    names; timed, with SDPA over the gathered pages and the bound, at the
    checked shape (S = 1, fills {0..1024}), the serving decode shape, the
    full pool and the 256-token piece, eager and graph-replayed."""
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    # the S <= 8 cases draw from their own generator, the row-block cases
    # from another
    g = torch.Generator(device=dev).manual_seed(3)
    g_rows = torch.Generator(device=dev).manual_seed(4)
    rec, timed = None, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for hkv, s, quant, fill_list in PAGED_CASES:
            if fill_list == SPLIT_FILLS:
                fill_list = _split_fills(torch, pa, hkv, s)
            q, kp, vp, table, fills, ks, vs = _paged_case(
                torch, dev, g if s <= 8 else g_rows, dtype, hkv, s, quant,
                fill_list)
            plan = pa.paged_plan(8, s, 12, hkv, 64, 64, 16, dtype, kp.dtype)
            if s <= 8:  # bf16 verify widths past DECODE_MAX_S: chunk
                want = ("decode" if s <= pa.DECODE_MAX_S
                        or dtype == torch.float32 else "chunk")
                check(plan.variant == want,
                      f"K1 at S={s} takes the {plan.variant} variant")
            before_variants = dict(pa.variant_launches)
            out = pa.paged_attention_chunk(q, kp, vp, table, fills, ks, vs)
            ref = pa.paged_attention_chunk_plain(q, kp, vp, table, fills,
                                                 ks, vs)
            check(pa.variant_launches[plan.variant]
                  == before_variants[plan.variant] + 1,
                  f"K1 did not launch its {plan.variant} variant")
            tag = (f"paged {name} slots=8 N=128 P=64 H=12 Hkv={hkv} S={s}"
                   f"{' int8' if quant else ''} fills {list(fill_list)} "
                   f"({plan.variant}: {plan.blocks} row blocks of "
                   f"{plan.rows}, {plan.splits} splits of "
                   f"{plan.pages_per_split} pages, {plan.smem} B)")
            err = compare(out, ref, name, tag)
            check(bool((out[0] == 0).all()) or fill_list[0] != 0,
                  "empty slot is not zero")
            before = (fills[:, None] - s + torch.arange(s, device=dev)) < 0
            check(bool((out[before] == 0).all()),
                  f"{tag}: a query with no key is not zero")
            if dtype != torch.bfloat16 or quant or hkv != 12:
                continue
            if (s, fill_list) == (1, PAGED_FILLS):
                rec = _paged_record(torch, pa, q, kp, vp, table, fills, err,
                                    "8 slots, fills {0..1024}, S=1 bf16")
            elif (s, fill_list) == (1, SERVE_FILLS):
                timed["decode_shape"] = _paged_record(
                    torch, pa, q, kp, vp, table, fills, err,
                    "8 slots at fill 716, S=1 bf16")
                q, kp, vp, table, fills, _, _ = _paged_case(
                    torch, dev, g, dtype, hkv, s, quant, (1024,) * 8)
                timed["full_pool"] = _paged_record(
                    torch, pa, q, kp, vp, table, fills, compare(
                        pa.paged_attention_chunk(q, kp, vp, table, fills),
                        pa.paged_attention_chunk_plain(q, kp, vp, table,
                                                       fills), name,
                        "paged bfloat16 8 slots at fill 1024, S=1"),
                    "8 slots at fill 1024, S=1 bf16")
            elif (s, fill_list) == (256, PAGED_FILLS):
                timed["piece"] = _paged_record(
                    torch, pa, q, kp, vp, table, fills, err,
                    "8 slots, fills {0..1024}, S=256 bf16")
    rec.update(timed)
    for r in (rec, *timed.values()):
        log(f"  K1 {r['shape']}: kernel {r['ms']:.4f} ms, graph-replayed "
            f"{r['graph_ms']:.4f}; SDPA over gathered pages "
            f"{r['library_ms']:.4f}, graph-replayed "
            f"{r['library_graph_ms']:.4f}; plain {r['plain_ms']:.4f}; bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
    return rec


# K1's cases at head_dim 128 and 8 query heads: (S, int8 pages, fills,
# KV heads). S <= 4 runs the decode variant with H / Hkv x S query rows
# a KV head, in CTAs of 1, 2, 4 or 8 rows (GQA and verify chunks: each
# instantiation at least once); the 256-token piece runs the chunk
# variant (bf16, float and int8 pages, GQA), the first design in f32.
PAGED_D128_CASES = ((1, False, PAGED_FILLS, 8), (1, True, PAGED_FILLS, 8),
                    (1, False, SERVE_FILLS, 8), (1, False, PAGED_FILLS, 4),
                    (1, False, PAGED_FILLS, 2), (1, False, PAGED_FILLS, 1),
                    (1, True, PAGED_FILLS, 1), (4, False, PAGED_FILLS, 8),
                    (4, False, PAGED_FILLS, 2), (4, True, PAGED_FILLS, 1),
                    (256, False, PAGED_FILLS, 8), (256, True, PAGED_FILLS, 8),
                    (256, False, PAGED_FILLS, 2))


def check_paged_d128(torch, dev):
    """K1 at head_dim 128 (8 heads; the phase-7c model's decode is H =
    Hkv = 8, S = 1): every case of ``PAGED_D128_CASES`` in bf16 and f32
    against the plain version, each call on the variant ``paged_plan``
    names, the decode variant's CTAs holding 1, 2, 4 and 8 query rows in
    each dtype;
    timed (bf16) at the serving decode shape, (e), and at the piece, (h),
    beside SDPA over the gathered pages and the bound, and the first
    design (``rows``, what D 128 ran before these variants took it) at
    both, graph-replayed
    in turns with the new variants."""
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(17)
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        decode_rows = set()
        for s, quant, fill_list, hkv in PAGED_D128_CASES:
            q, kp, vp, table, fills, ks, vs = _paged_case(
                torch, dev, g, dtype, hkv, s, quant, fill_list, h=8, d=128)
            plan = pa.paged_plan(8, s, 8, hkv, 128, 64, 16, dtype, kp.dtype)
            want = ("decode" if s <= pa.DECODE_MAX_S else
                    "chunk" if dtype == torch.bfloat16 else "rows")
            check(plan.variant == want,
                  f"K1 at D=128 S={s} takes the {plan.variant} variant")
            before = pa.variant_launches[want]
            out = pa.paged_attention_chunk(q, kp, vp, table, fills, ks, vs)
            ref = pa.paged_attention_chunk_plain(q, kp, vp, table, fills,
                                                 ks, vs)
            check(pa.variant_launches[want] == before + 1,
                  f"K1 at D=128 did not launch its {want} variant")
            if want == "decode":
                decode_rows.add(plan.rows)
            tag = (f"paged {name} slots=8 N=128 P=64 H=8 Hkv={hkv} D=128 "
                   f"S={s}"
                   f"{' int8' if quant else ''} fills {list(fill_list)} "
                   f"({plan.variant}: {plan.blocks} row blocks of "
                   f"{plan.rows}, {plan.splits} splits of "
                   f"{plan.pages_per_split} pages, {plan.stages} stages, "
                   f"{plan.smem} B)")
            err = compare(out, ref, name, tag)
            before_rows = (fills[:, None] - s
                           + torch.arange(s, device=dev)) < 0
            check(bool((out[before_rows] == 0).all()),
                  f"{tag}: a query with no key is not zero")
            if dtype != torch.bfloat16 or quant or hkv != 8 or s == 4:
                continue
            key = "e" if s == 1 else "h"
            if s == 1 and fill_list != SERVE_FILLS:
                continue
            r = _paged_record(torch, pa, q, kp, vp, table, fills, err,
                              f"({key}) 8 slots " + (
                                  "at fill 716, H=8 D=128, S=1 bf16"
                                  if s == 1 else
                                  "at fills {0..1024}, H=8 D=128, S=256 "
                                  "bf16"))
            first = pa.paged_plan(8, s, 8, 8, 128, 64, 16, dtype, kp.dtype,
                                  variant="rows")
            first_out = pa._launch(q, kp, vp, table, fills, None, None,
                                   first)
            compare(first_out, ref, name, f"{tag} first design (rows)")
            # in turns: new, first, new, first
            new_fn = lambda: pa.paged_attention_chunk(  # noqa: E731
                q, kp, vp, table, fills)
            first_fn = lambda: pa._launch(  # noqa: E731
                q, kp, vp, table, fills, None, None, first)
            turns = [graph_ms(fn) for fn in (new_fn, first_fn, new_fn,
                                             first_fn)]
            r.update(first_graph_ms=min(turns[1], turns[3]),
                     turns_graph_ms=turns)
            timed[key] = r
        check(decode_rows == set(pa.DECODE_ROWS),
              f"K1 {name} at D=128: the decode variant ran CTAs of "
              f"{sorted(decode_rows)} query rows, not each of "
              f"{list(pa.DECODE_ROWS)}")
        log(f"  K1 {name} at D=128: decode variant checked at "
            f"{sorted(decode_rows)} query rows a CTA")
    for key, r in sorted(timed.items()):
        log(f"  K1 {r['shape']}: kernel {r['ms']:.4f} ms, graph-replayed "
            f"{r['graph_ms']:.4f}; SDPA over gathered pages "
            f"{r['library_ms']:.4f}, graph-replayed "
            f"{r['library_graph_ms']:.4f}; plain {r['plain_ms']:.4f}; bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}); in turns graph-replayed "
            f"new / first design / new / first "
            f"{' / '.join(f'{t:.4f}' for t in r['turns_graph_ms'])}; {CARD}")
    rec = timed["e"]
    rec["piece"] = timed["h"]
    return rec


def _sdpa_over_gathered(torch, q, kp, vp, table, fills):
    """Library yardstick (never called by the port): gather every table
    page, then ``scaled_dot_product_attention`` with each query row's
    causal key mask (query ``s`` at ``fill - S + s``)."""
    import torch.nn.functional as F

    n, p, hkv, d = kp.shape
    b, s, h, _ = q.shape
    safe = table.long().clamp(0, n - 1)
    k = kp[safe].reshape(b, -1, hkv, d).transpose(1, 2)
    v = vp[safe].reshape(b, -1, hkv, d).transpose(1, 2)
    q_abs = fills.long()[:, None] - s + torch.arange(s, device=q.device)
    keep = (torch.arange(k.shape[2], device=q.device)[None, None, :]
            <= q_abs[:, :, None])[:, None]
    return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                          attn_mask=keep,
                                          enable_gqa=hkv != h)


def _paged_bound(q, kp, table, fills):
    """K1's bound at these inputs: each slot's live K/V bytes of every
    KV head read once (the fill capped at the table's pages; int8 pages
    with their f32 scales), q read and the output written once, against
    4 operations per (query row, key it sees, head_dim element) over the
    peak for the query's type."""
    b, s, h, d = q.shape
    hkv = kp.shape[2]
    cap = table.shape[1] * kp.shape[1]
    per_token = 2 * hkv * (d * kp.element_size()
                           + (4 if kp.element_size() == 1 else 0))
    nbytes = 2 * q.numel() * q.element_size()
    ops = 0
    for fill in fills.tolist():
        live = max(0, min(fill, cap))
        nbytes += live * per_token
        ops += 4 * h * d * sum(max(0, min(fill - s + i + 1, live))
                               for i in range(s))
    return bound(nbytes, ops, str(q.dtype).split(".")[-1])


# -- phase 3d: K6, the int8-weight matmul ------------------------------------

# K6's checked weights (K, N): GPT-small's query/key/value/out, mlp_in,
# mlp_out and lm_head, and the cb --spec pair's lm_head (vocab 259: N
# neither a multiple of 16 nor of the 64-column tile), each at M = 1
# (one slot), 8 (phase 4's slots) and 40 (8 slots x a k = 4 verify)
INT8_SHAPES = ((768, 768), (768, 3072), (3072, 768), (768, 32000),
               (64, 259))
INT8_ROWS = (1, 8, 40)
# Dense weights one GPT-small decode step streams, as the products the
# yardstick runs: 12 layers x (query, key, value, out, mlp_in, mlp_out)
# and lm_head, ((K, N), calls): 73 products
INT8_STEP = (((768, 768), 48), ((768, 3072), 12), ((3072, 768), 12),
             ((768, 32000), 1))
# the same step as K6's launches (``layers.dense_group``): 12 x (the
# query/key/value group, out, mlp_in, mlp_out) and lm_head, ((K, (N,
# ...)), calls): 49 launches
INT8_STEP_CALLS = (((768, (768, 768, 768)), 12), ((768, (768,)), 12),
                   ((768, (3072,)), 12), ((3072, (768,)), 12),
                   ((768, (32000,)), 1))


def _int8_weight(torch, dev, g, k, n):
    """An int8 weight and its column scales, quantized as the exporter
    quantizes a normal(0, 0.02) kernel."""
    from pyspark_tf_gke_tpu_torch.ops.quant import quantize_tensor

    w = torch.randn(k, n, generator=g, device=dev) * 0.02
    qt = quantize_tensor(w)
    return qt.q.contiguous(), qt.scale.contiguous()


def _int8_bound(m, k, n, dtype_name):
    """K6's bound: the int8 weight, its f32 scales and x read once and y
    written once, against 2 M K N operations over the peak for x's
    type."""
    size = 2 if dtype_name == "bfloat16" else 4
    return bound(k * n + 4 * n + size * m * (k + n), 2 * m * k * n,
                 dtype_name)


def _one_kernel(torch, fn, what):
    """Profile one call of ``fn``: exactly one device kernel, K6's
    (``int8_mm_hopper``), and no second pass."""
    _, _, top = _profiled(torch, fn)
    names = [name for name, _ in top]
    check(len(names) == 1 and "int8_mm_hopper" in names[0],
          f"{what}: one call launched {names}")
    return names[0]


def _captured_equals_eager(torch, fn, what):
    """``fn``'s output replayed from a captured CUDA graph equals an
    eager call's bit for bit."""
    eager = fn().clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(out, eager), f"{what}: captured != eager")
    del graph


def check_int8_matmul(torch, dev):
    """K6 against ``int8_matmul_plain`` at every (K, N) of
    ``INT8_SHAPES`` and M of ``INT8_ROWS``, bf16 (TOL's bf16 rule) and
    f32 (TOL's f32 rule: both sides multiply the same f32 weights and
    differ in summation order only), and its grouped call (GPT-small's
    query/key/value) against each weight's plain product; each case
    timed (eager and graph-replayed) beside its plain version and beside
    ``torch.matmul`` on the weight already dequantized to x's dtype (what
    a dequantize-at-load port runs), with its bound. A split-K call and
    a grouped call each launch one kernel (the profiler's list), and a
    captured replay equals the eager call bit for bit. The record is one
    GPT-small decode step at M = 8 in bf16: K6's 49 launches
    (``INT8_STEP_CALLS``) beside the yardstick's 73 products
    (``INT8_STEP``) and their bound."""
    from pyspark_tf_gke_tpu_torch.ops import int8_matmul as im

    g = torch.Generator(device=dev).manual_seed(6)
    times = {}
    err_max = 0.0
    weights = {}
    for k, n in INT8_SHAPES:
        q, scale = weights[(k, n)] = _int8_weight(torch, dev, g, k, n)
        for name, dtype in (("bfloat16", torch.bfloat16),
                            ("float32", torch.float32)):
            w = (q.float() * scale).to(dtype)
            for m in INT8_ROWS:
                x = torch.randn(m, k, generator=g, device=dev).to(dtype)
                plan = im.int8_plan(m, k, n, dtype)
                before = im.launches
                out = im.int8_matmul(x, q, scale)
                torch.cuda.synchronize()
                check(im.launches == before + 1,
                      f"int8_matmul [{m},{k}]x[{k},{n}] did not count")
                tag = f"int8_matmul [{m},{k}]x[{k},{n}] {name} {plan}"
                err = compare(out, im.int8_matmul_plain(x, q, scale), name,
                              tag)
                if name == "bfloat16":
                    err_max = max(err_max, err)
                kern = lambda: im.int8_matmul(x, q, scale)  # noqa: E731
                lib = lambda: torch.matmul(x, w)  # noqa: E731
                bms, by = _int8_bound(m, k, n, name)
                t = dict(ms=cuda_ms(kern), graph_ms=graph_ms(kern),
                         plain_ms=cuda_ms(lambda: im.int8_matmul_plain(
                             x, q, scale)),
                         library_ms=cuda_ms(lib),
                         library_graph_ms=graph_ms(lib), bound_ms=bms,
                         bound_by=by)
                times[(m, k, (n,), name)] = t
                log(f"  K6 [{m},{k}]x[{k},{n}] {name}: kernel {t['ms']:.4f} "
                    f"ms, graph-replayed {t['graph_ms']:.4f}; plain "
                    f"{t['plain_ms']:.4f}; torch.matmul on the dequantized "
                    f"weight {t['library_ms']:.4f}, graph-replayed "
                    f"{t['library_graph_ms']:.4f}; bound {bms:.4f} ({by}); "
                    f"{CARD}")
    # the query/key/value group of a GPT-small layer: one launch, three
    # outputs
    group = [_int8_weight(torch, dev, g, 768, 768) for _ in range(3)]
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        for m in INT8_ROWS:
            x = torch.randn(m, 768, generator=g, device=dev).to(dtype)
            before = im.launches
            outs = im.int8_matmul_group(x, group)
            torch.cuda.synchronize()
            check(im.launches == before + 1, "the grouped K6 call did not "
                  "count one launch")
            plan = im.int8_plan(m, 768, (768,) * 3, dtype)
            for i, (out, (q, scale)) in enumerate(zip(outs, group)):
                err = compare(out, im.int8_matmul_plain(x, q, scale), name,
                              f"int8_matmul_group [{m},768]x3 [768,768] "
                              f"{name} output {i} {plan}")
                if name == "bfloat16":
                    err_max = max(err_max, err)
            kern = lambda: im.int8_matmul_group(x, group)  # noqa: E731
            t = dict(ms=cuda_ms(kern), graph_ms=graph_ms(kern))
            times[(m, 768, (768, 768, 768), name)] = t
            log(f"  K6 group [{m},768]x3 [768,768] {name}: kernel "
                f"{t['ms']:.4f} ms, graph-replayed {t['graph_ms']:.4f}; "
                f"{CARD}")
    x8 = torch.randn(8, 768, generator=g, device=dev).to(torch.bfloat16)
    q, scale = weights[(768, 768)]
    names = {_one_kernel(torch, lambda: im.int8_matmul(x8, q, scale),
                         "a split-K call ([8,768]x[768,768])"),
             _one_kernel(torch, lambda: im.int8_matmul_group(x8, group),
                         "a grouped call")}
    _captured_equals_eager(torch, lambda: im.int8_matmul(x8, q, scale),
                           "K6 [8,768]x[768,768]")
    _captured_equals_eager(torch, lambda: im.int8_matmul_group(
        x8, group)[2], "K6 group")
    log(f"  K6: one kernel a call ({', '.join(sorted(n[:60] for n in names))}"
        f"), no second pass; captured == eager bit for bit")
    rec = {key: sum(times[(8, k, ns, "bfloat16")][key] * calls
                    for (k, ns), calls in INT8_STEP_CALLS)
           for key in ("ms", "graph_ms")}
    rec.update({key: sum(times[(8, k, (n,), "bfloat16")][key] * calls
                         for (k, n), calls in INT8_STEP)
                for key in ("plain_ms", "library_ms", "library_graph_ms",
                            "bound_ms")})
    calls = sum(c for _, c in INT8_STEP_CALLS)
    rec.update(max_abs_err=err_max, bound_by="bytes", calls=calls,
               shape=f"one GPT-small decode step, M=8 bf16: {calls} K6 "
                     "launches (12 x (the [768,768] x3 group, [768,768], "
                     "[768,3072], [3072,768]) + [768,32000]) against 73 "
                     "products of the yardstick")
    log(f"  K6 {rec['shape']}: kernel {rec['ms']:.4f} ms, graph-replayed "
        f"{rec['graph_ms']:.4f}; torch.matmul on dequantized bf16 weights "
        f"{rec['library_ms']:.4f}, graph-replayed "
        f"{rec['library_graph_ms']:.4f}; bound {rec['bound_ms']:.4f}; "
        f"lm_head [8,768]x[768,32000] graph-replayed "
        f"{times[(8, 768, (32000,), 'bfloat16')]['graph_ms']:.4f} against "
        f"its bound {times[(8, 768, (32000,), 'bfloat16')]['bound_ms']:.4f}"
        f"; {CARD}")
    return rec


# -- phase 3c: the ring's block entry and its merge ---------------------------

# the block entry's checked cases: (dtype name, head_dim) at B=8 S=512 H=12
BLOCK_CASES = (("bfloat16", 64), ("float32", 64), ("bfloat16", 128))


def _block_inputs(torch, dev, g, dtype, b=8, s=512, h=12, d=64):
    """q, k, v, an output cotangent and an lse cotangent (nonzero), and a
    key mask padding ~10% of the keys and one batch row whole."""
    q, k, v, g_out = (torch.randn(b, s, h, d, generator=g, device=dev
                                  ).to(dtype) for _ in range(4))
    g_lse = torch.randn(b, s, h, generator=g, device=dev)
    kv_mask = torch.rand(b, s, generator=g, device=dev) > 0.1
    kv_mask[_masked_batch(b)] = False
    return q, k, v, g_out, g_lse, kv_mask.contiguous()


def _block_fwd_bwd(torch, fn, q, k, v, g_out, g_lse, kv_mask):
    """``(out, lse, [dq, dk, dv])`` of one block call whose two outputs
    take the cotangents ``g_out`` and ``g_lse``."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out, lse = fn(*leaves, kv_mask=kv_mask)
    torch.autograd.backward([out, lse], [g_out, g_lse])
    return out.detach(), lse.detach(), [t.grad for t in leaves]


def _block_counters():
    """Phase 3c's counters: K2f, K2dq, K2dkv and the block entry."""
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    return {"flash_attention_fwd": (fa, "launches"),
            "flash_attention_dq": (fa, "dq_launches"),
            "flash_attention_dkv": (fa, "dkv_launches"),
            "flash_attention_block": (fa, "block_launches")}


def _serve_counters():
    """The serving kernels' counters: K3, K2f, K1 and K6 (every serving
    phase decodes an int8 bundle)."""
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa
    from pyspark_tf_gke_tpu_torch.ops import int8_matmul as im
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    return {"layernorm": (ln, "launches"),
            "flash_attention_fwd": (fa, "launches"),
            "paged_attention": (pa, "launches"),
            "int8_matmul": (im, "launches")}


def _train_counters():
    """The training kernels' counters: K3, K3b, K2f, K2dq and K2dkv."""
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln

    return {"layernorm": (ln, "launches"),
            "layernorm_bwd": (ln, "bwd_launches"),
            "flash_attention_fwd": (fa, "launches"),
            "flash_attention_dq": (fa, "dq_launches"),
            "flash_attention_dkv": (fa, "dkv_launches")}


def _moved(counters):
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def _reset(torch, counters):
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def check_flash_block(torch, dev, counters=None):
    """``flash_attention_block`` (K2f forward, K2dq and K2dkv with
    ``delta - g_lse``) at B=8 S=512 H=12 in bf16 and f32 at D 64 and in
    bf16 at D 128, with a nonzero lse cotangent and a fully masked batch
    row: out and lse (NEG_INF on the empty rows) against
    ``flash_attention_block_plain``; dQ/dK/dV against autograd through
    the plain version in f32, and in bf16 against
    ``flash_attention_bwd_plain`` on the kernels' inputs (the forward's
    raw lse and out, the shifted delta: the plain version rounds P and
    dS where the kernels do, which autograd through the bf16 plain
    forward does not); each call moves every counter by one. Then times
    the bf16 D-64 call, forward and backward. Returns its record."""
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    counters = counters or _block_counters()
    g = torch.Generator(device=dev).manual_seed(16)
    rec = None
    for name, d in BLOCK_CASES:
        dtype = getattr(torch, name)
        q, k, v, g_out, g_lse, kv_mask = _block_inputs(torch, dev, g, dtype,
                                                       d=d)
        tag = f"{name} B=8 S=512 H=12 D={d}"
        _reset(torch, counters)
        out, lse, grads = _block_fwd_bwd(torch, fa.flash_attention_block, q,
                                         k, v, g_out, g_lse, kv_mask)
        torch.cuda.synchronize()
        moved = _moved(counters)
        check(all(n == 1 for n in moved.values()),
              f"block {tag}: launches {moved}, one each expected")
        ref_out, ref_lse = fa.flash_attention_block_plain(q, k, v, kv_mask)
        compare(out, ref_out, name, f"block {tag} out")
        empty = ref_lse == fa.NEG_INF
        check(bool(((lse == fa.NEG_INF) == empty).all())
              and bool(empty[_masked_batch(8)].all()),
              f"block {tag}: the empty rows' lse is not NEG_INF")
        compare(lse[~empty], ref_lse[~empty], "float32", f"block {tag} lse")
        if dtype == torch.float32:
            ref = _block_fwd_bwd(torch, fa.flash_attention_block_plain, q, k,
                                 v, g_out, g_lse, kv_mask)[2]
        else:
            _, raw = fa.flash_attention_fwd(q, k, v, kv_mask)
            shift = torch.where(torch.isposinf(raw), 0.0,
                                g_lse.transpose(1, 2))
            delta = ((g_out.float() * out.float()).sum(-1).transpose(1, 2)
                     - shift).contiguous()
            ref = fa.flash_attention_bwd_plain(q, k, v, g_out, raw, delta,
                                               kv_mask)
        errs = [compare(got, want, name, f"block {tag} {what}")
                for got, want, what in zip(grads, ref, ("dq", "dk", "dv"))]
        row = _masked_batch(8)
        check(all(bool((t[row] == 0).all()) for t in grads),
              f"block {tag}: the fully masked batch row has a gradient")
        if name == "bfloat16" and d == 64:
            rec = _block_record(torch, fa, q, k, v, g_out, g_lse, kv_mask,
                                max([float((out.float() - ref_out.float())
                                           .abs().max())] + errs))
    return rec


def _block_record(torch, fa, q, k, v, g_out, g_lse, kv_mask, err):
    """The block entry's forward and backward timed eager and
    graph-replayed, beside the plain version and the efficient-attention
    op that also returns the logsumexp (its backward takes the output's
    cotangent only)."""
    b, s, h, d = q.shape
    name = str(q.dtype).split(".")[-1]
    shape = f"B={b} S={s} H={h} D={d} {name.replace('bfloat16', 'bf16')}"

    def fwd_bwd(fn):
        return lambda: _block_fwd_bwd(torch, fn, q, k, v, g_out, g_lse,
                                      kv_mask)

    kernel = fwd_bwd(fa.flash_attention_block)
    ms = cuda_ms(kernel)
    plain = cuda_ms(fwd_bwd(fa.flash_attention_block_plain))
    graphed = graph_ms(kernel)
    lib, lib_graph = _efficient_attention_times(torch, q, k, v, g_out,
                                                kv_mask)
    # reads q, k, v, dO, the mask and the lse cotangent; writes out, lse,
    # dq, dk and dv. Per (query, unmasked key) pair the function needs 6
    # products of D (QK and PV forward; dP, dV, dQ and dK backward), 12 D
    # operations; the kernels' recomputed S and dP are not part of it
    row = q.numel() * q.element_size()
    vec = b * s * h * 4
    nbytes = 8 * row + 2 * vec + kv_mask.numel()
    pairs = h * s * int(kv_mask.sum())
    bms, by = bound(nbytes, 12 * d * pairs, name)
    log(f"  flash_attention_block {shape} forward + backward ({CARD}): "
        f"kernel {ms:.4f} ms, graph-replayed {graphed}, plain {plain:.4f}, "
        f"efficient attention {lib}, graph-replayed {lib_graph}, bound "
        f"{bms:.4f} ({by})")
    return dict(max_abs_err=err, ms=ms, graph_ms=graphed, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib,
                library_graph_ms=lib_graph, shape=shape + " fwd+bwd")


def _efficient_attention_times(torch, q, k, v, g_out, kv_mask):
    """``aten._scaled_dot_product_efficient_attention`` with the key mask
    as an additive bias and ``compute_log_sumexp=True``, forward and
    backward, eager and graph-replayed; (None, None) if it refuses the
    inputs (logged)."""
    b, s, h, d = q.shape
    qt, kt, vt, gt = (t.transpose(1, 2) for t in (q, k, v, g_out))
    bias = torch.zeros(b, 1, 1, s, dtype=q.dtype, device=q.device)
    bias = bias.masked_fill(~kv_mask[:, None, None, :], -1e4).expand(
        b, h, s, s)

    def fwd_bwd():
        own = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        out = torch.ops.aten._scaled_dot_product_efficient_attention(
            *own, bias, True)[0]
        torch.autograd.grad(out, own, gt)

    try:
        eager = cuda_ms(fwd_bwd)
    except RuntimeError as exc:
        log(f"  efficient attention refused the inputs, not measured: "
            f"{str(exc).splitlines()[0]}")
        torch.cuda.synchronize()
        return None, None
    try:
        return eager, graph_ms(fwd_bwd)
    except RuntimeError as exc:  # torch.AcceleratorError included
        log(f"  efficient attention graph capture failed, not measured: "
            f"{str(exc).splitlines()[0]}")
        torch.cuda.synchronize()
        return eager, None


def check_ring_merge(torch, dev, counters=None):
    """The ring's block-and-merge arithmetic in one process (four sp
    ranks' worth): S = 512 split into 4 blocks, the key padding covering
    the last block whole (K2f on a 128-key block with no key at all) and
    one batch row whole; each query block through
    ``ops.attention.flash_block_merge`` (the ring's flash engine:
    ``flash_attention_block`` against each K/V block, merged by
    logsumexp) over the four K/V blocks. Output and q/k/v gradients must
    equal K2f/K2dq/K2dkv over the whole sequence, bf16 and f32. Returns
    the block entry's launches in the merges."""
    from pyspark_tf_gke_tpu_torch.ops import attention as att
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    counters = counters or _block_counters()
    g = torch.Generator(device=dev).manual_seed(17)
    blocks = [slice(128 * j, 128 * (j + 1)) for j in range(4)]
    total = {}
    for name in ("bfloat16", "float32"):
        dtype = getattr(torch, name)
        q, k, v, g_out, _, kv_mask = _block_inputs(torch, dev, g, dtype)
        kv_mask[:, 384:] = False
        _reset(torch, counters)
        lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
        out = torch.cat([att.flash_block_merge(
            lq[:, qs], ((lk[:, ks], lv[:, ks], kv_mask[:, ks].contiguous())
                        for ks in blocks)) for qs in blocks], dim=1)
        out.backward(g_out)
        torch.cuda.synchronize()
        moved = _moved(counters)
        check(all(n == 16 for n in moved.values()),
              f"ring merge {name}: launches {moved}, 16 each expected")
        for key, n in moved.items():
            total[key] = total.get(key, 0) + n
        rq, rk, rv = (t.detach().requires_grad_() for t in (q, k, v))
        ref = fa.flash_attention(rq, rk, rv, kv_mask=kv_mask)
        ref.backward(g_out)
        tag = f"ring merge {name} B=8 S=4x128 H=12 D=64"
        compare(out.detach(), ref.detach(), name, f"{tag} out vs K2f")
        for got, want, what in ((lq, rq, "dq"), (lk, rk, "dk"),
                                (lv, rv, "dv")):
            compare(got.grad, want.grad, name, f"{tag} {what} vs K2dq/K2dkv")
        check(not bool(lk.grad[:, 384:].any() or lv.grad[:, 384:].any()),
              f"{tag}: the padded block has a gradient")
    log(f"  launches in the two merges: {total}")
    return total


# -- phase 4: the main path ---------------------------------------------------


def _prompt(rng: random.Random, n: int) -> str:
    words = ("paged", "attention", "kernel", "hopper", "serving", "token",
             "cache", "slot", "batch", "decode", "prefill", "layer")
    out = ""
    while len(out) < n:
        out += rng.choice(words) + " "
    return out[:n]


def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def _phase4_jobs(rng: random.Random) -> list:
    """Phase 4's 12 ``/v1/generate`` bodies: prompts of 20-700 bytes,
    16-64 new tokens, two of them sampled (top-p, their own seeds)."""
    lengths = (20, 100, 300, 700)
    jobs = []
    for i in range(12):
        body = {"prompt": _prompt(rng, lengths[i % 4]),
                "max_new_tokens": (16, 32, 48, 64)[(i * 7) % 4]}
        if i in (3, 8):
            body.update(temperature=0.8, top_p=0.9, seed=100 + i)
        jobs.append(body)
    return jobs


def run_main_path(torch, dev, counters, cfg):
    from pyspark_tf_gke_tpu_torch.models.causal_lm import init_params
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa
    from pyspark_tf_gke_tpu_torch.train.export import export_serving_bundle
    from pyspark_tf_gke_tpu_torch.train.serve import (BundleServer,
                                                      start_http_server)

    t0 = time.perf_counter()
    bundle = PORT_PKG / "_build" / "chip_smoke_bundle"
    export_serving_bundle(cfg, init_params(cfg, seed=0), str(bundle),
                          quantize=True)
    # --peak-flops at the H100's bf16 peak arms /metrics' serve_mfu
    server = BundleServer(str(bundle), device=str(dev), continuous_slots=8,
                          continuous_chunk=16, peak_flops=PEAK_OPS["bfloat16"])
    httpd = start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    log(f"  bundle exported and served in {time.perf_counter() - t0:.1f} s "
        f"({url})")
    try:
        rng = random.Random(0)
        jobs = _phase4_jobs(rng)
        # warm-up: the server's engine captures its greedy and its
        # sampled 16-step decode chunk here (the only sizes this
        # server dispatches: a fixed chunk, no budget, no adaptive)
        _post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 2})
        _post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 2,
                                     "temperature": 0.8, "seed": 1})
        torch.cuda.synchronize()
        for mod, attr in counters.values():  # count only the traffic below
            setattr(mod, attr, 0)
        for variant in pa.variant_launches:
            pa.variant_launches[variant] = 0
        results, errors = [None] * len(jobs), []

        def client(idx):
            for j in range(idx, len(jobs), 3):
                try:
                    results[j] = _post(url + "/v1/generate", jobs[j])
                except Exception as exc:  # noqa: BLE001 — reported below
                    errors.append(f"request {j}: {exc}")

        t_start = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(900)
        wall = time.perf_counter() - t_start
        check(not errors, "; ".join(errors))
        texts = [_prompt(rng, n) for n in (40, 200, 600, 1000)]
        score = _post(url + "/v1/score", {"texts": texts})
        torch.cuda.synchronize()
        launches = {name: getattr(mod, attr)
                    for name, (mod, attr) in counters.items()}
        variants = dict(pa.variant_launches)
        engine_stats = server.health()["continuous"]
        with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
            mfu = [float(line.split()[1]) for line in
                   resp.read().decode().splitlines()
                   if line.startswith("serve_mfu ")]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        thread.join(30)
    new_tokens = 0
    for body, res in zip(jobs, results):
        check(res is not None and res[0] == 200, f"generate failed: {res}")
        comps = res[1]["completions"]
        check(len(comps) == 1 and comps[0]["prompt"] == body["prompt"]
              and comps[0]["completion"].startswith(body["prompt"])
              and 0 <= comps[0]["new_tokens"] <= body["max_new_tokens"]
              and comps[0]["latency_ms"] > 0, f"malformed completion {comps}")
        new_tokens += comps[0]["new_tokens"]
        log(f"  generate prompt={len(body['prompt'])}B "
            f"max_new={body['max_new_tokens']} "
            f"{'sampled' if 'seed' in body else 'greedy '} -> "
            f"{comps[0]['new_tokens']} tokens, latency_ms "
            f"{comps[0]['latency_ms']}")
    check(score[0] == 200 and len(score[1]["scores"]) == 4,
          f"score failed: {score}")
    for text, sc in zip(texts, score[1]["scores"]):
        check(math.isfinite(sc["nll"]) and sc["nll"] > 0
              and sc["tokens"] == min(len(text), cfg.max_seq_len) - 1,
              f"malformed score {sc}")
    log(f"  score: {[round(s['nll'], 3) for s in score[1]['scores']]}")
    log(f"  aggregate {new_tokens} new tokens in {wall:.3f} s = "
        f"{new_tokens / wall:.1f} tokens/s (12 requests, 3 clients; the "
        f"engine launching its decode steps one by one gave 152.3) on {CARD}")
    phases = engine_stats["step_phases"]
    log(f"  engine: pipeline_depth {engine_stats['pipeline_depth']}, "
        f"{engine_stats['decode_graphs']} decode graphs, "
        f"{engine_stats['dispatched_steps']} decode steps; step_phases "
        f"host_overhead_frac {phases['host_overhead_frac']}, host_work_frac "
        f"{phases['host_work_frac']}, wall p50 {phases['wall_ms'].get('p50')} "
        f"ms over {phases['records']} steps")
    log(f"  /metrics serve_mfu at --peak-flops {PEAK_OPS['bfloat16']:g} "
        f"(the windowed model FLOPs a second over the peak): {mfu}")
    check(len(mfu) == 1 and mfu[0] > 0,
          f"serve_mfu {mfu} after traffic with --peak-flops set")
    check(engine_stats["pipeline_depth"] == 1,
          "the server's default is not decode-ahead depth 1")
    check(engine_stats["decode_graphs"] == 2,
          f"{engine_stats['decode_graphs']} decode graphs captured, expected "
          "the greedy and the sampled 16-step chunk")
    log(f"  kernel launches on the main path: {launches}; K1 by variant "
        f"{variants}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    check(variants["decode"] > 0, "the decode steps did not launch K1's "
          "decode variant")
    shutil.rmtree(bundle, ignore_errors=True)
    return launches, variants, server.model


def _profiled(torch, fn, spans=False):
    """``(host wall ms, device busy ms, [(kernel, ms), ...])`` of one
    call of ``fn`` under ``torch.profiler`` (busy = the sum of the
    device time of every kernel, copy and set); with ``spans``, also the
    ms the device had any of them running (their intervals' union: less
    than the sum where a kernel launched early overlaps the one before
    it)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per_kernel = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        per_kernel.append((ev.key, us / 1e3))
    per_kernel.sort(key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in per_kernel)
    if not spans:
        return wall, busy, per_kernel
    union, end = 0.0, float("-inf")
    for start, stop in sorted(
            (ev.time_range.start, ev.time_range.end) for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA):
        if stop > end:
            union += stop - max(start, end)
            end = stop
    return wall, busy, per_kernel, union / 1e3


def _matmul_ms(top):
    """``(K6 ms, cuBLAS ms)`` of a profile's kernels: the int8-weight
    matmul, and cuBLAS's GEMV/GEMM kernels (``nvjet_*`` on this CUDA: the
    Dense layers of a model holding float weights; the dense engine's
    attention einsums land there too)."""
    k6 = sum(ms for name, ms in top if "int8_mm" in name)
    lib = sum(ms for name, ms in top
              if any(s in name.lower() for s in ("gemv", "gemm", "nvjet",
                                                 "splitkreduce")))
    return k6, lib


def profile_engine(torch, full_model, label="int8 paged"):
    """Where one batched prefill admission and one decode chunk of the
    full-width model spend their time: host wall clock against the
    device-busy total from ``torch.profiler``, the top kernels, and the
    Dense layers' share (K6, or cuBLAS on float weights). The chunk is a
    replay of the engine's captured 16-step graph (captured by an
    unprofiled first chunk); the profile of a paged model must show K1's
    decode kernel inside it, that of an int8 model K6. Returns the
    replayed chunk's wall ms unprofiled, its ``(wall ms, device ms)``
    profiled and its ``(K6 ms, cuBLAS ms)``."""
    from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine

    rng = random.Random(2)
    eng = ContinuousEngine(full_model, num_slots=8, chunk=16)
    for _ in range(8):
        eng.submit([rng.randrange(256) for _ in range(700)],
                   max_new_tokens=300)
    wall, busy, top = _profiled(torch, eng._admit_waiting)
    log(f"  prefill admission, 8 x 700-token prompts (bucket 1024): wall "
        f"{wall:.2f} ms, device busy {busy:.2f} ms")
    t0 = time.perf_counter()
    eng.step()  # the first chunk captures the 16-step graph
    torch.cuda.synchronize()
    log(f"  first decode chunk (warm-up + capture + replay): wall "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms; capture "
        f"{eng.graph_capture_seconds}")
    result = None
    for what in ("decode chunk, 16 steps x 8 live slots, graph replay",
                 "decode chunk again (steady state)"):
        wall, busy, top, union = _profiled(torch, eng.step, spans=True)
        if busy <= 0:
            raise SmokeFailure(f"{what}: torch.profiler shows no device "
                               "time for a replayed graph")
        k6, lib = _matmul_ms(top)
        log(f"  {label} {what}: wall {wall:.2f} ms, device busy {busy:.2f} "
            f"ms ({100 * busy / wall:.1f}%; {union:.2f} ms with a kernel "
            f"running), idle "
            f"{100 * (1 - busy / wall):.1f}%; Dense layers: K6 {k6:.3f} ms, "
            f"cuBLAS {lib:.3f} ms (PERF.md §5: 4.51 ms of bf16 GEMVs) "
            f"on {CARD}")
        for name, ms in top[:6]:
            log(f"    {ms:9.3f} ms  {name[:90]}")
        if full_model.cfg.paged_kv:
            decode = [ms for name, ms in top if "paged_decode" in name]
            check(bool(decode) and decode[0] > 0, "the replayed decode "
                  "chunk's profile shows no K1 decode kernel")
        if full_model.lm_head.kernel.dtype == torch.int8:
            check(k6 > 0, "the replayed decode chunk's profile shows no K6")
        result = (wall, busy, union)
        shares = (k6, lib)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"  {label} decode chunk without the profiler: wall "
        f"{', '.join(f'{w:.2f}' for w in walls)} ms for 16 steps (launched "
        f"step by step: 137-210 ms for 18.16 ms of device time) on {CARD}")
    # the captured greedy chunk replayed back to back (its device-side
    # state advances 16 tokens a replay; 7 replays stay inside the
    # slots' pages): CUDA events, the device's time with its gaps between
    # kernels and without the engine's host work
    replay = eng._graphs[(16, False)].graph.replay
    replay_ms = cuda_ms(replay, warmup=1, iters=2, reps=3)
    log(f"  {label} decode chunk graph replayed alone: {replay_ms:.3f} ms "
        f"for 16 steps (CUDA events) on {CARD}")
    return statistics.median(walls), result, shares, replay_ms


# -- phase 5: parity on the card ----------------------------------------------


def check_parity(torch, dev, full_model, cfg):
    from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                           generate,
                                                           init_params)
    from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine

    with torch.device(dev):
        model = CausalLM(cfg)
    model.load_params(init_params(cfg, seed=1)).eval()
    rng = random.Random(1)
    prompts = [[rng.randrange(256) for _ in range(n)]
               for n in (20, 100, 300, 700, 5, 50)]
    eng = ContinuousEngine(model, num_slots=8, chunk=16)
    rids = {eng.submit(p, max_new_tokens=24): p for p in prompts}
    got = dict(eng.run_until_drained())
    for rid, p in rids.items():
        ref = generate(model, [p], 24)[0, len(p):].tolist()
        check(got[rid] == ref, f"engine tokens {got[rid]} != generate {ref} "
              f"(prompt {len(p)} tokens)")
    log(f"  f32 2-layer engine greedy tokens == dense generate for "
        f"{len(prompts)} prompts (24 tokens each)")

    # a config asking for plain attention must not run it on the card
    with torch.device(dev):
        off = CausalLM(dataclasses.replace(cfg, use_flash=False))
    off.load_state_dict(model.state_dict())
    try:
        with torch.inference_mode():
            off.eval()(torch.tensor([prompts[4]], device=dev))
    except ValueError as exc:
        log(f"  use_flash=False on cuda raises: {exc}")
    else:
        raise SmokeFailure("use_flash=False ran plain attention on the card")

    plain = _plain_twin(torch, full_model)
    ids = torch.randint(0, full_model.cfg.vocab_size,
                        (2, full_model.cfg.max_seq_len),
                        generator=torch.Generator(device=dev).manual_seed(4),
                        device=dev)
    with torch.inference_mode():
        out = full_model(ids)
        ref = plain(ids)
    diff = (out - ref).abs()
    rel = float(diff.norm() / ref.norm())
    max_abs = float(diff.max())
    log(f"  full-width bf16 prefill logits {list(out.shape)}, kernels vs plain: "
        f"max_abs {max_abs:.4f} (tolerance 0.25), relative L2 {rel:.2e} "
        f"(tolerance 2e-2)")
    check(bool(torch.isfinite(out).all()), "non-finite logits")
    check(max_abs <= 0.25 and rel <= 2e-2,
          "bf16 prefill logits through the kernels disagree with plain")


def _plain_twin(torch, model):
    """``model``'s weights (int8 kernels and tables with their scales as
    they are held) in a model of its config with ``use_kernels=False``."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLM
    from pyspark_tf_gke_tpu_torch.models.layers import flax_tree

    with torch.device(model.device):
        plain = CausalLM(model.cfg, use_kernels=False)
    return plain.load_params(flax_tree(model)).eval()


def check_paged_piece(torch, dev, full_model):
    """Two 256-token pieces of chunked prefill (the JAX bench's chip
    piece, ``bench.py:1199``) through the full-width paged model's
    ``_paged_decode_attend`` on 4 slots at ragged offsets, with the
    kernels (K1's chunk variant on 256 query rows a head: two 128-row
    blocks) against ``use_kernels=False`` on its own cache, as phase 5's
    prefill logits."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import PagedKV
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    cfg = full_model.cfg
    plain = _plain_twin(torch, full_model)
    b, piece, starts = 4, 256, (0, 37, 64, 200)
    caches = [PagedKV(cfg, b, dev) for _ in range(2)]
    per_slot = cfg.max_pages_per_slot
    for kv in caches:  # slot i owns pages [i * 16, i * 16 + 16)
        kv.block_table.copy_(torch.arange(b * per_slot, dtype=torch.int32,
                                          device=dev).reshape(b, per_slot))
    ids = torch.randint(0, cfg.vocab_size, (b, 2 * piece),
                        generator=torch.Generator(device=dev).manual_seed(6),
                        device=dev)
    start = torch.tensor(starts, device=dev)[:, None]
    launches = pa.launches
    chunks = pa.variant_launches["chunk"]
    for i in range(2):
        pos = start + i * piece + torch.arange(piece, device=dev)[None]
        chunk = ids[:, i * piece:(i + 1) * piece]
        with torch.inference_mode():
            out = full_model(chunk, positions=pos, cache=caches[0])
            ref = plain(chunk, positions=pos, cache=caches[1])
        diff = (out - ref).abs()
        rel = float(diff.norm() / ref.norm())
        max_abs = float(diff.max())
        log(f"  paged piece {i + 1}: {b} slots x {piece} tokens at "
            f"positions {[int(v) for v in pos[:, 0]]}.., logits "
            f"{list(out.shape)}, kernels vs plain: max_abs {max_abs:.4f} "
            f"(tolerance 0.25), relative L2 {rel:.2e} (tolerance 2e-2)")
        check(bool(torch.isfinite(out).all()), "non-finite paged logits")
        check(max_abs <= 0.25 and rel <= 2e-2, "a 256-token paged piece "
              "through the kernels disagrees with plain")
    launched = pa.launches - launches
    chunked = pa.variant_launches["chunk"] - chunks
    check(launched == chunked == 2 * cfg.num_layers,
          f"K1 launched {launched} times ({chunked} on its chunk variant) "
          f"for 2 pieces x {cfg.num_layers} layers")
    kp = caches[0].pages(0)[0]
    plan = pa.paged_plan(b, piece, cfg.num_heads, cfg.kv_heads, cfg.head_dim,
                         cfg.kv_page_size, per_slot, cfg.dtype, kp.dtype)
    log(f"  K1 launched {launched} times, all on its chunk variant (S = "
        f"{piece}: {plan})")
    # K1 alone on one layer of the pieces' own cache: the second piece's
    # positions, a seeded query, against its plain version at phase 3's
    # tolerance (the logits above also carry the other kernels' rounding)
    kv = caches[0]
    kp, vp, ks, vs = kv.pages(cfg.num_layers - 1)
    fills = (start[:, 0] + 2 * piece).to(torch.int32)
    q = torch.randn(b, piece, cfg.num_heads, cfg.head_dim,
                    generator=torch.Generator(device=dev).manual_seed(7),
                    device=dev).to(cfg.dtype)
    with torch.inference_mode():
        out = pa.paged_attention_chunk(q, kp, vp, kv.block_table, fills,
                                       ks, vs)
        ref = pa.paged_attention_chunk_plain(q, kp, vp, kv.block_table,
                                             fills, ks, vs)
    compare(out, ref, str(cfg.dtype).split(".")[-1],
            f"paged piece: K1 on layer {cfg.num_layers - 1}'s cache, "
            f"S = {piece}, fills {[int(v) for v in fills]}")


# -- phase 4c: chunked prefill on the serving main path ------------------------

# The JAX bench's chunked-prefill configuration at full width
# (bench.py:1196-1199): GPT-small at 2048 positions, 8 slots, chunk 16,
# 64-token pages (a pool of 8 x 32), pieces of 256 under a 384-token
# step budget; 32 requests, every 4th with a 1024-token prompt and the
# rest 64, 64 new tokens each.
CB = dict(slots=8, chunk=16, page=64, prefill_chunk=256, budget=384,
          requests=32, short=64, long=1024, new=64)


def _cb_prompts(vocab: int):
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, CB["long"] if i % 4 == 3 else CB["short"]
                         ).astype(np.int32) for i in range(CB["requests"])]


def _drive_engine(torch, eng, prompts):
    """Submit every prompt at t0 and step to the end; returns ``(tokens
    by request, first-token seconds by request, [per request: the gaps
    between deliveries in ms], wall seconds, [per step: (ms, prefill
    pieces, decode steps)])``. A step ends in a device-to-host copy, so
    its end is when its tokens are delivered."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=CB["new"]) for p in prompts]
    reqs = {r.rid: r for r in eng._queue}
    seen = {rid: 0 for rid in rids}
    stamps = {rid: [] for rid in rids}
    steps = []
    while eng.busy:
        pieces, decode = eng._n_prefill_chunks, eng._n_dispatched_steps
        t_step = time.perf_counter()
        eng.step()
        now = time.perf_counter()
        steps.append(((now - t_step) * 1e3, eng._n_prefill_chunks - pieces,
                      eng._n_dispatched_steps - decode))
        for rid, req in reqs.items():
            if len(req.tokens) > seen[rid]:
                seen[rid] = len(req.tokens)
                stamps[rid].append(now)
    wall = time.perf_counter() - t0
    tokens = [list(reqs[r].tokens) for r in rids]
    ttft = [stamps[r][0] - t0 for r in rids]
    gaps = [[(b - a) * 1e3 for a, b in zip(stamps[r], stamps[r][1:])]
            for r in rids]
    return tokens, ttft, gaps, wall, steps


def _top2_margin(torch, model, ids) -> float:
    """The top-2 logit margin of ``model``'s next-token logits after
    ``ids`` (a full causal forward)."""
    with torch.inference_mode():
        logits = model(torch.tensor([ids], device=model.device))[0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def run_chunked_serving(torch, dev, counters):
    """Phase 4c: the same 32 arrivals through the unchunked engine and
    the chunked one (``prefill_chunk`` 256, ``step_token_budget`` 384) on
    a full-width GPT-small bundle (2048 positions, bf16, int8 export),
    after a warm-up of both, in turns (unchunked, chunked, chunked,
    unchunked). Gates: every request gets its 64 tokens,
    every kernel of the serving path launches during the chunked run,
    and every piece's K1 calls take the chunk variant (one a layer a
    piece); then an f32 run of the same arrivals at the full width cut to
    2 layers must give the unchunked engine's tokens exactly (on a
    mismatch the first divergent step's top-2 logit margin is printed).
    Prints time to first token and the largest gap between tokens of the
    short requests, new tokens a second and the engine's step times,
    chunked against unchunked. Returns the chunked run's launches and K1
    launches by variant."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig,
                                                           init_params)
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa
    from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
    from pyspark_tf_gke_tpu_torch.train.export import (export_serving_bundle,
                                                       load_serving_bundle)

    cfg = CausalLMConfig(max_seq_len=2048, kv_page_size=CB["page"],
                         kv_num_pages=CB["slots"] * 2048 // CB["page"])
    bundle = PORT_PKG / "_build" / "chip_smoke_cb_bundle"
    export_serving_bundle(cfg, init_params(cfg, seed=0), str(bundle),
                          quantize=True)
    model = load_serving_bundle(str(bundle), dev)[0]
    shutil.rmtree(bundle, ignore_errors=True)
    prompts = _cb_prompts(cfg.vocab_size)
    chunked_kw = dict(prefill_chunk=CB["prefill_chunk"],
                      step_token_budget=CB["budget"])

    def engine(m, chunked):
        # the server's default decode-ahead depth
        return ContinuousEngine(m, num_slots=CB["slots"], chunk=CB["chunk"],
                                pipeline_depth=1,
                                **(chunked_kw if chunked else {}))

    # one engine of each kind, warmed by a whole run of the traffic: the
    # decode chunks it dispatches (every budget-capped size) are captured
    # there, so the timed runs below only replay
    engines = {chunked: engine(model, chunked) for chunked in (False, True)}
    for chunked, eng in engines.items():
        _drive_engine(torch, eng, prompts)
        log(f"  {'chunked' if chunked else 'unchunked'} engine warmed: "
            f"graphs {sorted(eng.graph_capture_seconds)}, capture "
            f"{sum(eng.graph_capture_seconds.values()):.2f} s in all")
    # the two engines in turns (unchunked, chunked, chunked, unchunked):
    # host wall clocks drift by tens of percent within a call, so each
    # engine's numbers are the mean of its two runs; the counters count
    # the first chunked run
    results = {False: [], True: []}
    launches = variants = None
    for run, chunked in enumerate((False, True, True, False)):
        eng = engines[chunked]
        graphs = len(eng.graph_capture_seconds)
        before = dict(eng.stats)
        counted = chunked and launches is None
        if counted:
            torch.cuda.synchronize()
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            for variant in pa.variant_launches:
                pa.variant_launches[variant] = 0
        tokens, ttft, gaps, wall, steps = _drive_engine(torch, eng, prompts)
        if counted:
            torch.cuda.synchronize()
            launches = {name: getattr(mod, attr)
                        for name, (mod, attr) in counters.items()}
            variants = dict(pa.variant_launches)
        check(all(len(t) == CB["new"] for t in tokens),
              f"{'chunked' if chunked else 'unchunked'} engine: a request "
              "did not get its 64 tokens")
        short = [i for i, p in enumerate(prompts) if len(p) == CB["short"]]
        check(len(eng.graph_capture_seconds) == graphs,
              "a timed phase-4c run captured a new decode graph")
        r = dict(wall_s=wall, tokens_per_s=sum(map(len, tokens)) / wall,
                 ttft_ms=statistics.median(ttft[i] * 1e3 for i in short),
                 ttft_max_ms=max(ttft[i] * 1e3 for i in short),
                 max_gap_ms=max(max(gaps[i]) for i in short),
                 pieces=(eng.stats["prefill_chunks"]
                         - before["prefill_chunks"]),
                 decode_steps=(eng.stats["dispatched_steps"]
                               - before["dispatched_steps"]))
        results[chunked].append(r)
        ms = [st[0] for st in steps]
        with_piece = [st[0] for st in steps if st[1]]
        slow = max(steps)
        log(f"  run {run + 1}, {'chunked  ' if chunked else 'unchunked'}: "
            f"{CB['requests'] * CB['new']} new tokens in {wall:.3f} s = "
            f"{r['tokens_per_s']:.1f} tokens/s; short requests' time to "
            f"first token median {r['ttft_ms']:.1f} ms, max "
            f"{r['ttft_max_ms']:.1f} ms; largest gap between tokens "
            f"{r['max_gap_ms']:.1f} ms; prefill pieces {r['pieces']}, "
            f"decode steps {r['decode_steps']}; {len(ms)} engine steps, "
            f"median {statistics.median(ms):.1f} ms, {len(with_piece)} with "
            f"a piece (median "
            f"{statistics.median(with_piece) if with_piece else 0:.1f} ms), "
            f"slowest {slow[0]:.1f} ms ({slow[1]} pieces, {slow[2]} decode "
            "steps)")
    mean = {c: {key: statistics.mean(r[key] for r in rs) for key in
                ("tokens_per_s", "ttft_ms", "max_gap_ms")}
            for c, rs in results.items()}
    log(f"  chunked / unchunked, means of two runs each: tokens/s "
        f"{mean[True]['tokens_per_s'] / mean[False]['tokens_per_s']:.3f}, "
        f"median TTFT {mean[True]['ttft_ms'] / mean[False]['ttft_ms']:.3f}, "
        f"largest gap "
        f"{mean[True]['max_gap_ms'] / mean[False]['max_gap_ms']:.3f} (serial "
        f"engines launching step by step: 0.538, 1.548, 1.433) on {CARD}")
    pieces = results[True][0]["pieces"]
    log(f"  chunked run's launches {launches}; K1 by variant {variants}")
    n_long = sum(len(p) == CB["long"] for p in prompts)
    check(pieces == n_long * CB["long"] // CB["prefill_chunk"],
          f"{pieces} prefill pieces for {n_long} long prompts of "
          f"{CB['long'] // CB['prefill_chunk']}")
    check(variants["chunk"] == pieces * cfg.num_layers,
          f"K1's chunk variant launched {variants['chunk']} times for "
          f"{pieces} pieces x {cfg.num_layers} layers")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the chunked path")

    # f32 (the full width, 2 layers): chunked == unchunked, token for token
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype=torch.float32)
    with torch.device(dev):
        m32 = CausalLM(cfg32)
    m32.load_params(init_params(cfg32, seed=1)).eval()
    outs = {chunked: _drive_engine(torch, engine(m32, chunked), prompts)[0]
            for chunked in (False, True)}
    for i, (a, b) in enumerate(zip(outs[True], outs[False])):
        if a != b:
            j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
            margin = _top2_margin(torch, m32, list(prompts[i]) + b[:j])
            raise SmokeFailure(
                f"f32 chunked engine diverges from the unchunked one at "
                f"request {i} (prompt {len(prompts[i])}), new token {j}: "
                f"{a[j]} != {b[j]}; top-2 logit margin there {margin:.3e}")
    log(f"  f32 2-layer chunked engine == unchunked engine for all "
        f"{len(prompts)} requests ({CB['new']} tokens each)")
    del model, m32
    return launches, variants


# -- phase 4d: the captured decode chunk against eager launches ---------------


def _graph_traffic(vocab: int):
    """16 requests for 8 slots: prompts of 20-700 tokens, 16-64 new
    tokens, every third one sampled (temperature 0.8, top-p 0.9, its
    own seed)."""
    rng = random.Random(4)
    out = []
    for i in range(16):
        n = (20, 100, 300, 700)[i % 4]
        out.append(dict(prompt_ids=[rng.randrange(vocab) for _ in range(n)],
                        max_new_tokens=(16, 24, 40, 64)[(i * 5) % 4],
                        **(dict(temperature=0.8, top_p=0.9, seed=100 + i)
                           if i % 3 == 2 else {})))
    return out


def _run_traffic(eng, traffic):
    """Submit every request, drain; ``(tokens by request, wall s)``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(**job) for job in traffic]
    done = dict(eng.run_until_drained())
    torch.cuda.synchronize()
    return [done[r] for r in rids], time.perf_counter() - t0


def check_decode_graphs(torch, dev, model=None):
    """Phase 4d on the GPT-small serving model (bf16, int8 export, 8
    slots, chunk 16): the captured chunks give the tokens of eager
    launches of the same body, bit for bit, greedy and sampled; depth 0,
    1 and 2 give identical per-request tokens; a replay-only run moves
    K1's decode counter by exactly its decode steps x layers;
    ``adaptive_chunk`` dispatches only its bucketed sizes. Prints each
    depth's new tokens/s and step_phases, and each graph's capture time.
    Returns the replay-only run's launches by kernel."""
    from pyspark_tf_gke_tpu_torch.obs.stepstats import StepStatsRing
    from pyspark_tf_gke_tpu_torch.ops import int8_matmul as im
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa
    from pyspark_tf_gke_tpu_torch.train import continuous as tc

    if model is None:
        model = _serving_model(torch, dev, _serving_cfg())
    cfg = model.cfg
    traffic = _graph_traffic(cfg.vocab_size)

    def engine(**kw):
        return tc.ContinuousEngine(model, num_slots=8, chunk=16, **kw)

    eager = engine()

    def eager_chunk(size, sampling):  # the same body, launched eagerly
        toks = tc._decode_chunk(model, eager._state, size,
                                eager.eos_token_id, eager.pad_id, sampling)
        return toks.cpu(), eager._state.live.cpu(), None

    eager._chunk_async = eager_chunk
    ref, eager_s = _run_traffic(eager, traffic)
    check(not eager._graphs, "the eager engine captured a graph")
    sampled = [i for i, job in enumerate(traffic) if "seed" in job]
    runs = {}
    for depth in (0, 1, 2):
        eng = engine(pipeline_depth=depth)
        first, first_s = _run_traffic(eng, traffic)  # captures
        check(first == ref, f"depth {depth}: the captured chunks' tokens "
              "differ from eager launches of the same body")
        eng.stepstats = StepStatsRing()
        for mod, attr in ((pa, "launches"), (ln, "launches"),
                          (im, "launches")):
            setattr(mod, attr, 0)
        for variant in pa.variant_launches:
            pa.variant_launches[variant] = 0
        steps0 = eng.stats["dispatched_steps"]
        again, wall = _run_traffic(eng, traffic)  # replays only
        steps = eng.stats["dispatched_steps"] - steps0
        check(again == ref, f"depth {depth}: a replayed run's tokens differ")
        check(pa.variant_launches["decode"] == steps * cfg.num_layers,
              f"depth {depth}: K1's decode variant counted "
              f"{pa.variant_launches['decode']} launches for {steps} decode "
              f"steps x {cfg.num_layers} layers")
        # every int8 Dense of a decode step streams through K6, the
        # query/key/value group one launch (prefill admissions dequantize
        # into transients)
        per_step = model.k6_launches_per_step()
        check(im.launches == steps * per_step,
              f"depth {depth}: K6 counted {im.launches} launches for "
              f"{steps} decode steps x {per_step} launches a step")
        phases = eng.stats["step_phases"]
        new = sum(map(len, again))
        runs[depth] = dict(launches={"paged_attention": pa.launches,
                                     "layernorm": ln.launches,
                                     "int8_matmul": im.launches})
        log(f"  depth {depth}: {new} new tokens in {wall:.3f} s = "
            f"{new / wall:.1f} tokens/s (first run, capturing: "
            f"{first_s:.3f} s; eager launches {eager_s:.3f} s); "
            f"host_overhead_frac {phases['host_overhead_frac']}, "
            f"host_work_frac {phases['host_work_frac']}, step wall p50 "
            f"{phases['wall_ms']['p50']} ms over {phases['records']} steps; "
            f"K1 decode {pa.variant_launches['decode']} launches = {steps} "
            f"steps x {cfg.num_layers} layers, K3 {ln.launches}, K6 "
            f"{im.launches} = {steps} x {per_step}; on {CARD}")
        log("    capture (warm-up + capture) s by (size, sampling): "
            + ", ".join(f"{k}: {v:.3f}" for k, v in
                        sorted(eng.graph_capture_seconds.items())))
        check(sorted(eng.graph_capture_seconds) == [(16, False), (16, True)],
              f"graphs {sorted(eng.graph_capture_seconds)}")
    log(f"  eager == captured == depth 0, 1, 2 token for token for "
        f"{len(traffic)} requests ({len(sampled)} sampled)")
    adaptive = engine(pipeline_depth=1, adaptive_chunk=True)
    sizes, inner = [], adaptive._dispatch_chunk
    adaptive._dispatch_chunk = lambda size: (sizes.append(size),
                                             inner(size))[1]
    got, wall = _run_traffic(adaptive, traffic)
    check(got == ref, "adaptive_chunk changed the tokens")
    check(set(sizes) <= {8, 16} and 8 in sizes,
          f"adaptive_chunk dispatched sizes {sorted(set(sizes))}")
    check({k[0] for k in adaptive.graph_capture_seconds} <= {8, 16},
          f"adaptive graphs {sorted(adaptive.graph_capture_seconds)}")
    log(f"  adaptive_chunk (depth 1): sizes {sorted(set(sizes))} over "
        f"{len(sizes)} dispatches, graphs "
        f"{sorted(adaptive.graph_capture_seconds)}, tokens == fixed chunk "
        f"({wall:.3f} s with its captures)")
    return runs[1]["launches"]


def _serving_cfg():
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLMConfig

    # GPT-small paged as the cb bench pages it: 64-token pages, slots x
    # 16 of them (phase 4's configuration)
    return CausalLMConfig(kv_page_size=64, kv_num_pages=128)


def _serving_model(torch, dev, cfg, name="chip_smoke_graph_bundle"):
    """A GPT-small bundle of ``cfg`` with random weights (numpy seed 0),
    exported with int8 weights and loaded on the card."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import init_params
    from pyspark_tf_gke_tpu_torch.train.export import (export_serving_bundle,
                                                       load_serving_bundle)

    bundle = PORT_PKG / "_build" / name
    export_serving_bundle(cfg, init_params(cfg, seed=0), str(bundle),
                          quantize=True)
    model = load_serving_bundle(str(bundle), dev)[0]
    shutil.rmtree(bundle, ignore_errors=True)
    return model


# -- phase 4e: the radix prefix cache and the KV handoff -----------------------

# The JAX bench's prefix-cache traffic (bench.py:1330-1400, the non-smoke
# shape) on the GPT-small serving model: 16 requests sharing one
# 512-token system prompt, each with a 32-token unique suffix and 16 new
# tokens; 4 slots, chunk 8, 64-token pages, pieces of 128, the pool sized
# as the bench sizes it (live slots + the resident prefix).
PC = dict(slots=4, chunk=8, page=64, prefill_chunk=128, requests=16,
          shared=512, suffix=32, new=16)


def _audit_pages(eng) -> None:
    """The page audit of ``tests/test_radix_cache.py``: free and
    referenced pages partition the pool, every trie page is referenced
    and indexed once."""
    total = eng.model.cfg.kv_num_pages
    free, refd = eng._free_pages, set(eng._page_refs)
    check(len(free) == len(set(free)), "a page is free twice")
    check(not (set(free) & refd), "a page is both free and referenced")
    check(len(free) + len(refd) == total,
          f"pages lost: {len(free)} free + {len(refd)} referenced != {total}")
    check(all(n > 0 for n in eng._page_refs.values()), "a zero refcount")
    if eng.radix is not None:
        trie = eng.radix.indexed_pages()
        check(len(trie) == len(set(trie)), "a page is indexed twice")
        check(set(trie) <= refd, "the trie indexes an unreferenced page")
        check(len(trie) == eng.radix.resident_pages, "resident count drifts")


def run_radix_serving(torch, dev, counters):
    """Phase 4e: the bench's shared-prefix traffic with the radix cache
    off, then warmed and on; then the cached prefix pages exported from
    the cached engine, packed, unpacked and imported into a fresh
    engine, which serves the same traffic. Gates: the same tokens three
    ways; prefill tokens with the cache on = the warm's 512 + the
    suffixes, after the import the suffixes only; the page audit green
    after every step; K1's chunk and decode variants and K3 launch. Each
    engine is warmed first by two unrelated requests (its decode graph
    captured there). Returns the cached run's launches."""
    import numpy as np

    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLMConfig
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa
    from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
    from pyspark_tf_gke_tpu_torch.train.kv_transfer import (pack_kv_export,
                                                            unpack_kv_blob)

    probe = CausalLMConfig()
    pool = (PC["slots"] * (probe.max_seq_len // PC["page"])
            + PC["shared"] // PC["page"] + 2)
    cfg = CausalLMConfig(kv_page_size=PC["page"], kv_num_pages=pool)
    model = _serving_model(torch, dev, cfg, "chip_smoke_radix_bundle")
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, PC["shared"]).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, vocab, PC["suffix"]).astype(np.int32)])
        for _ in range(PC["requests"])]
    unrelated = [rng.integers(0, vocab, 40).astype(np.int32)
                 for _ in range(2)]

    def engine(cached):
        eng = ContinuousEngine(
            model, num_slots=PC["slots"], chunk=PC["chunk"],
            prefill_chunk=PC["prefill_chunk"], pipeline_depth=1,
            prefix_cache_size=pool if cached else 0)
        for p in unrelated:
            eng.submit(p, max_new_tokens=4)
        list(eng.run_until_drained())
        return eng

    def run(eng, warm=None, count=False):
        if count:
            torch.cuda.synchronize()
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            for variant in pa.variant_launches:
                pa.variant_launches[variant] = 0
        computed0 = eng.stats["prefill_tokens_computed"]
        pc0 = dict(eng.stats.get("prefix_cache") or {})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if warm is not None:
            eng.warm_prefix(warm)
        rids = [eng.submit(p, max_new_tokens=PC["new"]) for p in prompts]
        done = {}
        while eng.busy:
            for req in eng.step():
                done[req.rid] = list(req.tokens)
            _audit_pages(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        toks = [done[r] for r in rids]
        check(all(len(t) == PC["new"] for t in toks),
              "a request did not get its 16 tokens")
        pc = eng.stats.get("prefix_cache") or {}
        out = dict(tokens=toks, wall=wall,
                   tokens_per_s=PC["requests"] * PC["new"] / wall,
                   computed=eng.stats["prefill_tokens_computed"] - computed0,
                   hits=pc.get("hits", 0) - pc0.get("hits", 0),
                   misses=pc.get("misses", 0) - pc0.get("misses", 0),
                   resident=pc.get("resident_pages", 0))
        if count:
            torch.cuda.synchronize()
            out["launches"] = {name: getattr(mod, attr)
                               for name, (mod, attr) in counters.items()}
            out["variants"] = dict(pa.variant_launches)
        return out

    off = run(engine(False))
    cached_eng = engine(True)
    on = run(cached_eng, warm=shared, count=True)
    suffixes = PC["requests"] * PC["suffix"]
    check(on["tokens"] == off["tokens"],
          "the radix cache changed the tokens")
    check(off["computed"] == PC["requests"] * (PC["shared"] + PC["suffix"]),
          f"cache off prefilled {off['computed']} tokens")
    check(on["computed"] == PC["shared"] + suffixes,
          f"cache on prefilled {on['computed']} tokens, expected the warm's "
          f"{PC['shared']} + {suffixes} of suffixes")
    check(on["hits"] == PC["requests"] and on["misses"] == 0,
          f"hits {on['hits']}, misses {on['misses']}")
    for name, n in on["launches"].items():
        if name != "flash_attention_fwd":  # pieces only: no bucket prefill
            check(n > 0, f"kernel {name} was not launched on the radix path")
    check(on["variants"]["chunk"] > 0 and on["variants"]["decode"] > 0,
          f"K1 by variant {on['variants']}")
    export = cached_eng.export_prefix_pages(shared)
    blob = pack_kv_export(export)
    back = unpack_kv_blob(blob)
    fresh = engine(True)
    check(fresh.import_prefix_pages(back["token_ids"], back["layers"])
          == PC["shared"], "the import did not cover the shared prompt")
    _audit_pages(fresh)
    imported = run(fresh)
    check(imported["tokens"] == off["tokens"],
          "the imported pages changed the tokens")
    check(imported["computed"] == suffixes,
          f"after the import {imported['computed']} tokens were prefilled, "
          f"expected the {suffixes} of suffixes")
    log(f"  cache off: {off['tokens_per_s']:.1f} new tokens/s "
        f"({off['wall']:.3f} s), {off['computed']} prefill tokens")
    log(f"  cache on (warm inside the timed window): "
        f"{on['tokens_per_s']:.1f} new tokens/s ({on['wall']:.3f} s), "
        f"{on['computed']} prefill tokens, hit rate "
        f"{on['hits'] / max(on['hits'] + on['misses'], 1):.3f}, "
        f"{on['resident']} resident pages; on / off tokens/s "
        f"{on['tokens_per_s'] / off['tokens_per_s']:.3f}; on {CARD}")
    log(f"  KV handoff: {len(export['layers'])} layers x "
        f"{export['layers'][0]['k_pages'].shape[0]} pages, blob "
        f"{len(blob) / 2**20:.1f} MiB; the importing engine: "
        f"{imported['tokens_per_s']:.1f} new tokens/s, {imported['computed']} "
        "prefill tokens, tokens == cache off")
    log(f"  cached run's launches {on['launches']}; K1 by variant "
        f"{on['variants']}")
    del model, cached_eng, fresh
    return on["launches"], on["variants"]


# -- phase 4f: in-engine speculative decoding ---------------------------------

# bench.py cb --spec (bench_spec_cb, bench.py:1479-1560), full mode: a
# 12-layer hidden-64 target trained 800 Adam steps on the skewed chain, a
# 1-layer hidden-32 draft distilled 1200 steps on the target's greedy
# rollouts; vocab 259, 256 positions, f32, 32-token pages, a pool of 16,
# 2 slots, chunk 64, adaptive chunks, k = 5; 8 prompts of 16 tokens, 128
# new tokens each
SPEC = dict(k=5, steps=800, distill_steps=1200, distill_rows=64, slots=2,
            chunk=64, page=32, requests=8, plen=16, new=128, skew=0.8)
# the GPT-small runs: phase 4's bundle and requests, 8 slots, chunk 16,
# decode-ahead depth 1, k = 5
SPEC_K = 5


def _spec_pair(torch, dev):
    """The cb --spec pair trained on the card by the port's ``_train_lm``
    (f32, no TF32): ``(target, draft, seconds)``, dense f32 serving
    models."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig,
                                                           generate,
                                                           init_params)
    from pyspark_tf_gke_tpu_torch.train.spec_fixture import (_pack_rows,
                                                             _train_lm)

    common = dict(vocab_size=259, max_seq_len=256, dtype=torch.float32)
    tcfg = CausalLMConfig(hidden_size=64, num_layers=12, num_heads=4,
                          intermediate_size=128, **common)
    dcfg = CausalLMConfig(hidden_size=32, num_layers=1, num_heads=2,
                          intermediate_size=64, **common)

    def train(cfg, rows, steps, seed):
        with torch.device(dev):
            model = CausalLM(cfg, param_dtype=torch.float32)
            served = CausalLM(cfg)
        model.load_params(init_params(cfg, seed=seed))
        _train_lm(model, rows, steps, lr=3e-3)
        served.load_state_dict(model.state_dict())
        return served.eval()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    target = train(tcfg, _pack_rows(64, n_rows=32, seed=0, skew=SPEC["skew"]),
                   SPEC["steps"], seed=0)
    # distil the draft on the target's own greedy rollouts
    seeds = _pack_rows(8, n_rows=SPEC["distill_rows"], seed=3,
                       skew=SPEC["skew"])
    rollouts = generate(target, seeds, 56).cpu().numpy()
    draft = train(dcfg, rollouts, SPEC["distill_steps"], seed=1)
    torch.cuda.synchronize()
    return target, draft, time.perf_counter() - t0


def _first_divergence(torch, model, prompts, got, want, what):
    """Raise with the first divergent token's top-2 logit margin."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            margin = _top2_margin(torch, model, list(prompts[i]) + b[:j])
            raise SmokeFailure(
                f"{what}: request {i} (prompt {len(prompts[i])}) diverges "
                f"at new token {j}: {a[j:j + 1]} != {b[j:j + 1]}; top-2 "
                f"logit margin there {margin:.3e}")


def _identical_share(got, want):
    """Share of positions where two token lists agree, over requests."""
    same = sum(x == y for a, b in zip(got, want) for x, y in zip(a, b))
    return same / max(sum(len(b) for b in want), 1)


def _spec_trained(torch, dev):
    """Phase 4f (a) and (c): the trained pair through the paged engine
    with speculation on and off (warmed, then in turns), and through the
    standalone driver's two loops."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLM, generate
    from pyspark_tf_gke_tpu_torch.models.speculative import (
        speculative_generate)
    from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
    from pyspark_tf_gke_tpu_torch.train.spec_fixture import _pack_rows

    target, draft, train_s = _spec_pair(torch, dev)
    log(f"  (a) the cb --spec pair trained on the card in {train_s:.1f} s "
        f"({SPEC['steps']} + {SPEC['distill_steps']} Adam steps, f32)")
    pool = SPEC["slots"] * target.cfg.max_seq_len // SPEC["page"]
    with torch.device(dev):
        paged = CausalLM(dataclasses.replace(
            target.cfg, kv_page_size=SPEC["page"], kv_num_pages=pool))
    paged.load_state_dict(target.state_dict())
    paged.eval()
    prompts = [p.tolist() for p in _pack_rows(
        SPEC["plen"], n_rows=SPEC["requests"], seed=5, skew=SPEC["skew"])]
    traffic = [dict(prompt_ids=p, max_new_tokens=SPEC["new"])
               for p in prompts]

    def engine(spec):
        kw = dict(spec_tokens=SPEC["k"], draft_model=draft) if spec else {}
        return ContinuousEngine(paged, num_slots=SPEC["slots"],
                                chunk=SPEC["chunk"], adaptive_chunk=True,
                                **kw)

    engines = {spec: engine(spec) for spec in (False, True)}
    for eng in engines.values():  # warm: every graph captured here
        _run_traffic(eng, traffic)
    runs = {False: [], True: []}
    spec0 = dict(engines[True].stats["spec"])
    for spec in (False, True, True, False):
        eng = engines[spec]
        n_graphs = len(eng.graph_capture_seconds)
        toks, wall = _run_traffic(eng, traffic)
        check(len(eng.graph_capture_seconds) == n_graphs,
              "a timed phase-4f run captured a new graph")
        check(all(len(t) == SPEC["new"] for t in toks),
              "phase 4f (a): a request did not get its 128 tokens")
        runs[spec].append((toks, SPEC["requests"] * SPEC["new"] / wall))
    _first_divergence(torch, target, prompts, runs[True][0][0],
                      runs[False][0][0], "f32 spec on against off")
    st = engines[True].stats["spec"]
    prop = st["proposed"] - spec0["proposed"]
    acc = st["accepted"] - spec0["accepted"]
    rate = acc / max(prop, 1)
    check(0 < rate < 1, f"phase 4f (a) accept rate {rate} not in (0, 1)")
    on = statistics.mean(r for _, r in runs[True])
    off = statistics.mean(r for _, r in runs[False])
    log(f"  (a) spec on == off token for token (f32, {SPEC['requests']} x "
        f"{SPEC['new']} tokens); new tokens/s off "
        f"{', '.join(f'{r:.1f}' for _, r in runs[False])}, on "
        f"{', '.join(f'{r:.1f}' for _, r in runs[True])} (on / off "
        f"{on / off:.3f}); accept rate {rate:.4f} over {prop} proposed, "
        f"{1 + SPEC['k'] * rate:.3f} tokens a verify; graphs "
        f"{sorted(engines[True].graph_capture_seconds)}; on {CARD}")

    # (c) the standalone driver: both loops, the target's own tokens
    prompt = [prompts[0]]
    want = generate(target, prompt, SPEC["new"])[0].tolist()
    stats = {}
    for loop in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats[loop] = speculative_generate(
            target, draft, prompt, SPEC["new"], gamma=4, return_stats=True,
            device_loop=loop)
        wall = time.perf_counter() - t0
        check(out[0].tolist() == want, f"speculative_generate (device_loop="
              f"{loop}) differs from generate")
        log(f"  (c) speculative_generate device_loop={loop}: == generate, "
            f"{stats[loop]}, {wall * 1e3:.1f} ms with its capture")
    check(stats[True] == stats[False], "the device loop's stats differ "
          "from the host loop's")
    return dict(on=on, off=off, rate=rate, pair=(target, draft))


def run_spec_serving(torch, dev, counters=None):
    """Phase 4f: in-engine speculative decoding. (a) the trained cb --spec
    pair, spec on == off in f32 token for token, accept rate in (0, 1);
    (b) phase 4's GPT-small bundle over HTTP with ``--spec-tokens 5
    --draft-bundle`` (a random 1-layer hidden-768 draft), then through
    engines spec off / self-draft / random draft (warmed, timed runs
    capturing nothing): every request completes, the K1, K3 and K2f
    counters move, K1's verify calls take the variant ``paged_plan``
    names for S = 6, a replayed spec chunk equals eager launches of its
    body bit for bit (greedy and sampled), an f32 2-layer cut gives spec
    off's tokens for both drafts; a replayed spec chunk profiled;
    (c) the standalone driver's loops == ``generate``. Returns the
    self-draft timed run's launches by kernel."""
    from pyspark_tf_gke_tpu_torch.data.text import ByteTokenizer
    from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig,
                                                           init_params)
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa
    from pyspark_tf_gke_tpu_torch.train import continuous as tc
    from pyspark_tf_gke_tpu_torch.train.export import export_serving_bundle
    from pyspark_tf_gke_tpu_torch.train.serve import (BundleServer,
                                                      start_http_server)

    if counters is None:
        counters = _serve_counters()
    trained = _spec_trained(torch, dev)

    # (b) GPT-small: phase 4's bundle and a random 1-layer draft bundle
    cfg = _serving_cfg()
    dcfg = CausalLMConfig(num_layers=1)
    root = PORT_PKG / "_build"
    tdir, ddir = root / "chip_smoke_spec_bundle", root / "chip_smoke_draft"
    export_serving_bundle(cfg, init_params(cfg, seed=0), str(tdir),
                          quantize=True)
    export_serving_bundle(dcfg, init_params(dcfg, seed=1), str(ddir),
                          quantize=True)
    server = BundleServer(str(tdir), device=str(dev), continuous_slots=8,
                          continuous_chunk=16, spec_tokens=SPEC_K,
                          draft_bundle_dir=str(ddir))
    httpd = start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    jobs = _phase4_jobs(random.Random(0))
    try:
        t0 = time.perf_counter()
        results = [_post(url + "/v1/generate", body) for body in jobs]
        wall = time.perf_counter() - t0
        health = server.health()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        thread.join(30)
        shutil.rmtree(tdir, ignore_errors=True)
        shutil.rmtree(ddir, ignore_errors=True)
    for body, (code, res) in zip(jobs, results):
        check(code == 200 and res["completions"][0]["completion"].startswith(
            body["prompt"]), f"spec generate failed: {code} {res}")
    spec = health["continuous"]["spec"]
    check(spec["proposed"] > 0 and not spec["self_draft"]
          and health["speculative_draft"] == str(ddir),
          f"the server's spec block {spec}")
    log(f"  (b) HTTP, --spec-tokens {SPEC_K} --draft-bundle (random "
        f"1-layer draft), 12 requests one at a time: {wall:.2f} s with the "
        f"captures; /healthz continuous.spec {spec}")
    model, draft = server.model, server.draft_model
    tok = ByteTokenizer()
    traffic = []
    for body in jobs:
        job = dict(prompt_ids=tok.encode(body["prompt"]),
                   max_new_tokens=body["max_new_tokens"])
        for key in ("temperature", "top_p", "seed"):
            if key in body:
                job[key] = body[key]
        traffic.append(job)
    greedy = [i for i, job in enumerate(traffic) if "seed" not in job]
    prompts = [job["prompt_ids"] for job in traffic]
    new = sum(job["max_new_tokens"] for job in traffic)

    def engine(m, kind, d=None, **kw):
        spec = ({} if kind == "off" else dict(
            spec_tokens=SPEC_K, draft_model=None if kind == "self" else d))
        return tc.ContinuousEngine(m, num_slots=8, chunk=16,
                                   pipeline_depth=1, **spec, **kw)

    plan = pa.paged_plan(8, SPEC_K + 1, cfg.num_heads, cfg.kv_heads,
                         cfg.head_dim, cfg.kv_page_size,
                         cfg.max_pages_per_slot, torch.bfloat16,
                         torch.bfloat16)
    runs, launches, variants = {}, None, None
    for kind in ("off", "self", "random"):
        eng = engine(model, kind, draft)
        first, first_s = _run_traffic(eng, traffic)  # captures
        n_graphs = len(eng.graph_capture_seconds)
        counted = kind == "self"
        if counted:
            torch.cuda.synchronize()
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            for v in pa.variant_launches:
                pa.variant_launches[v] = 0
            rounds0, steps0 = eng._n_spec_rounds, eng._n_dispatched_steps
        toks, wall = _run_traffic(eng, traffic)
        if counted:
            torch.cuda.synchronize()
            launches = {name: getattr(mod, attr)
                        for name, (mod, attr) in counters.items()}
            variants = dict(pa.variant_launches)
            rounds = eng._n_spec_rounds - rounds0
            chunks = (eng._n_dispatched_steps - steps0
                      - rounds * (2 * SPEC_K + 2)) // 2
        check(len(eng.graph_capture_seconds) == n_graphs,
              f"a timed phase-4f {kind} run captured a new graph")
        check(all(len(t) == job["max_new_tokens"]
                  for t, job in zip(toks, traffic)),
              f"phase 4f {kind}: a request did not complete")
        check(toks == first, f"phase 4f {kind}: the replayed run's tokens "
              "differ from the capturing run's")
        runs[kind] = dict(toks=toks, tps=new / wall, first_s=first_s,
                          stats=eng.stats, graphs=sorted(
                              eng.graph_capture_seconds))
    layers = cfg.num_layers
    verify = rounds * layers
    exits = chunks * layers
    if plan.variant == "decode":
        check(variants["decode"] == verify + exits,
              f"K1 decode launches {variants['decode']} != (rounds {rounds}"
              f" + chunks {chunks}) x {layers}")
    else:
        check(variants[plan.variant] == verify and variants["decode"] == exits,
              f"K1 by variant {variants}: {rounds} verify rounds x {layers} "
              f"on {plan.variant}, {chunks} exits x {layers} on decode")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the spec path")
    for kind in ("off", "self", "random"):
        r = runs[kind]
        extra = ""
        if kind != "off":
            g = [r["toks"][i] for i in greedy]
            w = [runs["off"]["toks"][i] for i in greedy]
            same = sum(a == b for a, b in zip(g, w))
            extra = (f"; greedy tokens identical to spec off "
                     f"{_identical_share(g, w):.4f} ({same}/{len(g)} "
                     f"requests whole); accept rate "
                     f"{r['stats']['spec']['accept_rate']}")
        log(f"  (b) {kind:6s}: {new} new tokens, {r['tps']:.1f} tokens/s "
            f"(first run with its captures {r['first_s']:.3f} s); graphs "
            f"{r['graphs']}{extra}; on {CARD}")
    log(f"  (b) self-draft timed run: {rounds} verify rounds, {chunks} spec "
        f"chunks; launches {launches}; K1 by variant {variants} (S = "
        f"{SPEC_K + 1} plans {plan.variant})")

    # a replayed spec chunk against eager launches of its body
    eager = engine(model, "self")

    def eager_spec(rounds_, sampling):
        packed = tc._spec_chunk(model, eager._draft, eager._state, rounds_,
                                SPEC_K, eager.eos_token_id, eager.pad_id,
                                sampling)
        return packed.cpu(), None

    eager._spec_async = eager_spec
    ref, eager_s = _run_traffic(eager, traffic)
    check(not eager._graphs, "the eager spec engine captured a graph")
    check(ref == runs["self"]["toks"], "replayed spec chunks differ from "
          "eager launches of the same body")
    log(f"  (b) replayed spec chunks == eager launches bit for bit "
        f"({len(traffic)} requests, {len(traffic) - len(greedy)} sampled; "
        f"eager {eager_s:.3f} s)")

    # f32, the full width cut to 2 layers: spec off's tokens, both drafts
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype=torch.float32)
    d32 = dataclasses.replace(dcfg, dtype=torch.float32)
    with torch.device(dev):
        m32, dm32 = CausalLM(cfg32), CausalLM(d32)
    m32.load_params(init_params(cfg32, seed=1)).eval()
    dm32.load_params(init_params(dcfg, seed=1)).eval()
    off32 = _run_traffic(engine(m32, "off"), traffic)[0]
    for kind in ("self", "random"):
        got = _run_traffic(engine(m32, kind, dm32), traffic)[0]
        _first_divergence(torch, m32, [prompts[i] for i in greedy],
                          [got[i] for i in greedy], [off32[i] for i in greedy],
                          f"f32 2-layer {kind}-draft spec against off")
    log(f"  (b) f32 2-layer: self-draft and random-draft spec == spec off "
        f"for the {len(greedy)} greedy requests")
    del m32, dm32

    # where a replayed spec chunk's time goes
    rng = random.Random(2)
    for kind in ("self", "random"):
        eng = tc.ContinuousEngine(model, num_slots=8, chunk=16,
                                  spec_tokens=SPEC_K,
                                  draft_model=None if kind == "self" else draft)
        for _ in range(8):
            eng.submit([rng.randrange(256) for _ in range(700)],
                       max_new_tokens=300)
        eng.step()  # admissions, the capture, one chunk
        wall_p, busy, top = _profiled(torch, eng.step)
        check(busy > 0, "the profiler shows no device time for a replayed "
              "spec chunk")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        rounds_ = eng._spec_rounds(16, None)
        log(f"  (b) a replayed {kind}-draft spec chunk ({rounds_} rounds of "
            f"k = {SPEC_K}, 8 slots at ~700 tokens): device {busy:.2f} ms "
            f"in a profiled wall of {wall_p:.2f} ms; unprofiled wall "
            f"{', '.join(f'{w:.2f}' for w in walls)} ms; on {CARD}")
        for name, ms in top[:6]:
            log(f"    {ms:9.3f} ms  {name[:90]}")
        del eng
    return launches, trained["pair"]


# -- phase 4g: the replica's fleet contract ------------------------------------

# /loadz's key set: the contract a router's prober reads (the JAX server's
# keys, pinned by its tests)
LOADZ_KEYS = frozenset({
    "queued", "queued_tokens", "active", "slots_total", "kv_pages_free",
    "inflight_http", "draining", "bundle_generation", "prefix_cache_pages",
    "prefix_hit_rate", "capacity_free", "queue_delay_ms", "tenants",
    "spec_accept_rate", "step_host_overhead_frac", "step_tokens_per_sec",
    "role"})
# (e)'s tenants: light and noisy at 3:1 flood; capped has a token bucket
FLEET_TENANTS = "light=3,noisy=1,capped=1:10:400"


def _call(url: str, path: str, body=None, headers=None):
    """``(status, headers, json body)`` of one request, errors included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.headers, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, err.headers, json.loads(err.read())


def _sse(url: str, body: dict, cut_after=None):
    """POST a stream; ``(events, done, ttft_s, gaps_s)``: the ``data:``
    payloads parsed, whether ``[DONE]`` closed it, the time to the first
    event and between events. ``cut_after``: close the socket after that
    many events (a client, or a replica, gone mid-stream)."""
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/generate", body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    check(resp.status == 200, f"stream answered {resp.status}")
    events, done, stamps = [], False, []
    for raw in resp:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        if line == "data: [DONE]":
            done = True
            break
        stamps.append(time.perf_counter())
        events.append(json.loads(line[6:]))
        if cut_after is not None and len(events) == cut_after:
            break
    resp.close()  # then the socket: a cut leaves the server writing
    conn.close()  # into a closed connection
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    return events, done, (stamps[0] - t0 if stamps else None), gaps


def _ids(events) -> list:
    return [t for e in events for t in e.get("token_ids", ())]


def _serve_bundle(torch, dev, bundle, **kw):
    from pyspark_tf_gke_tpu_torch.train.serve import (BundleServer,
                                                      start_http_server)

    server = BundleServer(str(bundle), device=str(dev), continuous_slots=8,
                          continuous_chunk=16, **kw)
    httpd = start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    # the greedy 16-step chunk's graph is captured here
    check(_call(url, "/v1/generate", {"prompt": "warm up",
                                      "max_new_tokens": 2})[0] == 200,
          "a warm-up request failed")
    return server, httpd, thread, url


def _unserve(server, httpd, thread) -> None:
    httpd.shutdown()
    httpd.server_close()
    server.shutdown()
    thread.join(30)


def _wait(cond, timeout_s=30.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _prefill_count(server) -> int:
    return server.health()["continuous"]["prefill_tokens_computed"]


def _fleet_streams(url, prompts, new):
    """(a): each prompt streamed alone, then sent blocking alone (a
    request alone takes one admission route, so bf16 tokens compare
    exactly); then all 8 streamed at once and all 8 blocking at once,
    twice in turns. Returns the timed figures."""
    ttfts, gaps = [], []
    for p in prompts:
        events, done, ttft, g = _sse(url, {"prompt": p, "stream": True,
                                           "max_new_tokens": new})
        check(done and events[-1].get("done"),
              "phase 4g (a): a stream did not end with its terminal and "
              "[DONE]")
        status, _, out = _call(url, "/v1/generate", {"prompt": p,
                                                     "max_new_tokens": new})
        check(status == 200, f"phase 4g (a): blocking answered {status}")
        comp = out["completions"][0]
        check(events[-1]["completion"] == comp["completion"]
              and events[-1]["new_tokens"] == comp["new_tokens"]
              == len(_ids(events[:-1])),
              "phase 4g (a): a stream's tokens differ from the blocking "
              "request's")
        ttfts.append(ttft)
        gaps += g
    rates = {"stream": [], "blocking": []}
    for kind in ("stream", "blocking", "stream", "blocking"):
        counts = [0] * len(prompts)

        def client(i, kind=kind, counts=counts):
            if kind == "stream":
                events, done, _, _ = _sse(url, {"prompt": prompts[i],
                                                "stream": True,
                                                "max_new_tokens": new})
                check(done, "phase 4g (a): a concurrent stream was cut")
                counts[i] = events[-1]["new_tokens"]
            else:
                counts[i] = _call(url, "/v1/generate", {
                    "prompt": prompts[i], "max_new_tokens": new}
                    )[2]["completions"][0]["new_tokens"]

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        rates[kind].append(sum(counts) / (time.perf_counter() - t0))
    return ttfts, gaps, rates


def _fleet_splice(url, prompt, new):
    """(b): a stream cut after 10 events by closing the socket; its slot
    frees; a continuation with those ids completes the run exactly."""
    body = {"prompt": prompt, "stream": True, "max_new_tokens": new}
    whole, done, _, _ = _sse(url, body)
    check(done and len(whole) > 11, "phase 4g (b): the uncut stream has "
          f"{len(whole)} events, fewer than 10 and a terminal")
    cut, done, _, _ = _sse(url, body, cut_after=10)
    check(not done and len(cut) == 10, "phase 4g (b): the cut stream")
    check(_wait(lambda: _call(url, "/loadz")[2]["active"] == 0),
          "phase 4g (b): the abandoned stream's slot did not free")
    emitted = _ids(cut)
    rest, done, _, _ = _sse(url, {
        **body, "max_new_tokens": new - len(emitted),
        "continuation": {"emitted_ids": emitted}})
    check(done and rest[-1].get("resumed"), "phase 4g (b): the "
          "continuation did not complete as a resumed stream")
    check(emitted + _ids(rest[:-1]) == _ids(whole[:-1])
          and rest[-1]["completion"] == whole[-1]["completion"]
          and rest[-1]["new_tokens"] == whole[-1]["new_tokens"],
          "phase 4g (b): the spliced stream differs from the uncut one")
    return len(emitted), len(_ids(whole[:-1]))


def _fleet_handoff(prefill, decode, prompt, new, tag):
    """(c): ``/v1/prefill`` on the prefill server, its blob into the
    decode server's ``/v1/kv_import``, then the prompt on the decode
    server, which prefills only the tail past the imported pages.
    Returns the decode server's completion."""
    (_, purl), (ds, durl) = prefill, decode
    check(_call(purl, "/loadz")[2]["role"] == "prefill"
          and _call(durl, "/loadz")[2]["role"] == "decode",
          f"phase 4g (c) {tag}: the roles on /loadz")
    t0 = time.perf_counter()
    status, _, exp = _call(purl, "/v1/prefill", {"prompt": prompt})
    check(status == 200 and exp["blob"], f"phase 4g (c) {tag}: /v1/prefill "
          f"answered {status}")
    t1 = time.perf_counter()
    status, _, imp = _call(durl, "/v1/kv_import", {"blob": exp["blob"]})
    t2 = time.perf_counter()
    page = ds.model.cfg.kv_page_size
    full = len(prompt.encode()) // page * page
    check(status == 200 and imp["imported_tokens"] == full,
          f"phase 4g (c) {tag}: /v1/kv_import {status} {imp}")
    before = _prefill_count(ds)
    status, _, out = _call(durl, "/v1/generate", {"prompt": prompt,
                                                  "max_new_tokens": new})
    tail = _prefill_count(ds) - before
    check(status == 200 and tail == len(prompt.encode()) - full,
          f"phase 4g (c) {tag}: the decode server prefilled {tail} tokens, "
          f"not the {len(prompt.encode()) - full} past its {full // page} "
          "imported pages")
    log(f"  (c) {tag}: /v1/prefill {exp['pages']} pages, "
        f"{len(exp['blob']) * 3 // 4} bytes in {(t1 - t0) * 1e3:.1f} ms, "
        f"/v1/kv_import {(t2 - t1) * 1e3:.1f} ms; the decode server "
        f"prefilled the {tail} tokens past {full}")
    return out["completions"][0]


def _fleet_tenants(url, server):
    """(e): light and noisy flood their queues at once; while both are
    backlogged the admitted tokens split 3:1; then capped's quota and an
    oversize ask."""
    front = server._front
    # requests of 480 + 64 tokens: ~1.4 light admissions a DWRR rotation
    # (quantum 256 x weight 3), so the window spans ~40 rotations and
    # its ends cut few tokens off the shares
    prompt, new, n = _prompt(random.Random(5), 480), 64, 64
    samples = []
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            t = front.stats()["tenants"]
            samples.append({k: (t.get(k, {}).get("queued", 0),
                                t.get(k, {}).get("admitted_tokens", 0))
                            for k in ("light", "noisy")})
            time.sleep(0.002)

    statuses = []

    def client(tenant):
        statuses.append(_call(url, "/v1/generate", {
            "prompt": prompt, "max_new_tokens": new},
            headers={"X-Tenant": tenant})[0])

    poller = threading.Thread(target=poll)
    poller.start()
    threads = [threading.Thread(target=client, args=(t,))
               for _ in range(n) for t in ("light", "noisy")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    stop.set()
    poller.join()
    check(statuses.count(200) == 2 * n, "phase 4g (e): a flood request "
          "failed")
    # the window while both queues are backlogged: from the first sample
    # with 4 of each queued to the last before light's queue empties
    # (once it is empty, the free slots all go to noisy)
    start = next((i for i, s in enumerate(samples)
                  if s["light"][0] >= 4 and s["noisy"][0] >= 4), None)
    check(start is not None, "phase 4g (e): the queues never both held 4")
    end = next(i for i in range(start, len(samples))
               if samples[i]["light"][0] == 0) - 1
    light = samples[end]["light"][1] - samples[start]["light"][1]
    noisy = samples[end]["noisy"][1] - samples[start]["noisy"][1]
    share = light / max(noisy, 1)
    check(noisy > 0 and abs(share / 3.0 - 1.0) <= 0.15,
          f"phase 4g (e): admitted tokens light {light} / noisy {noisy} = "
          f"{share:.3f}, not 3 +- 15%")
    ok = _call(url, "/v1/generate", {"prompt": "q" * 100,
                                     "max_new_tokens": 200},
               headers={"X-Tenant": "capped"})
    shed = _call(url, "/v1/generate", {"prompt": "q" * 100,
                                       "max_new_tokens": 200},
                 headers={"X-Tenant": "capped"})
    big = _call(url, "/v1/generate", {"prompt": "q" * 100,
                                      "max_new_tokens": 400},
                headers={"X-Tenant": "capped"})
    check(ok[0] == 200, f"phase 4g (e): capped's first request {ok[0]}")
    check(shed[0] == 429 and shed[2]["reason"] == "tenant_quota"
          and int(shed[1]["Retry-After"]) >= 1
          and shed[1]["X-Tenant-Shed"] == "capped",
          f"phase 4g (e): capped's second request {shed[0]} {shed[2]}")
    check(big[0] == 400 and "burst" in big[2]["error"],
          f"phase 4g (e): an oversize ask {big[0]} {big[2]}")
    log(f"  (e) tenants light=3 noisy=1, {n} requests each of 480 + {new} "
        f"tokens: while both were backlogged ({end - start + 1} samples) "
        f"light took {light} admitted tokens, noisy {noisy}: {share:.3f}; "
        f"capped: 200, then 429 (Retry-After {shed[1]['Retry-After']}), "
        "an oversize ask 400")


def run_fleet_contract(torch, dev, counters=None):
    """Phase 4g: phase 4's bundle behind the port's ``BundleServer`` with
    the fleet contract's endpoints (GPT-small, bf16, int8 export, 8
    slots, chunk 16, decode-ahead depth 1), the f32 gates on the same
    width cut to 2 layers. (a) 8 greedy prompts streamed and blocking;
    (b) a stream cut after 10 events, continued; (c) a KV handoff from a
    ``--role prefill`` server to a ``--role decode`` one; (d) deadlines;
    (e) tenants at 3:1; (f) drain; (g) ``/loadz``'s key set. Every
    count is set to 0 before (a) and read after (g): K1's decode and
    chunk variants, K2f, K3 and the graph replays must all move.
    Returns the launches by kernel."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import init_params
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa
    from pyspark_tf_gke_tpu_torch.ops import graphs
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa
    from pyspark_tf_gke_tpu_torch.train.export import export_serving_bundle

    if counters is None:
        counters = _serve_counters()
    t_phase = time.perf_counter()
    cfg = _serving_cfg()
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype=torch.float32)
    root = PORT_PKG / "_build"
    b16, b32 = root / "chip_smoke_fleet_bundle", root / "chip_smoke_fleet32"
    export_serving_bundle(cfg, init_params(cfg, seed=0), str(b16),
                          quantize=True)
    export_serving_bundle(cfg32, init_params(cfg32, seed=1), str(b32))
    served = {
        "main": _serve_bundle(torch, dev, b16, tenants_spec=FLEET_TENANTS),
        "prefill": _serve_bundle(torch, dev, b16, prefix_cache_size=64,
                                 role="prefill"),
        "decode": _serve_bundle(torch, dev, b16, prefix_cache_size=64,
                                role="decode"),
        "ref32": _serve_bundle(torch, dev, b32),
        "prefill32": _serve_bundle(torch, dev, b32, prefix_cache_size=64,
                                   role="prefill"),
        "decode32": _serve_bundle(torch, dev, b32, prefix_cache_size=64,
                                  role="decode")}
    setup_s = time.perf_counter() - t_phase
    server, _, _, url = served["main"]
    rng = random.Random(4)
    try:
        torch.cuda.synchronize()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        for variant in pa.variant_launches:
            pa.variant_launches[variant] = 0
        graphs.replays = 0
        t_drive = time.perf_counter()

        # (a) streams against blocking
        prompts = [_prompt(rng, n) for n in (20, 60, 100, 200, 300, 40, 80,
                                             150)]
        ttfts, gaps, rates = _fleet_streams(url, prompts, 64)
        log(f"  (a) 8 greedy prompts of 20-300 B, 64 new tokens, each alone: "
            f"streamed == blocking; TTFT to the first event median "
            f"{statistics.median(ttfts) * 1e3:.2f} ms (min "
            f"{min(ttfts) * 1e3:.2f}, max {max(ttfts) * 1e3:.2f}); mean gap "
            f"between events {statistics.mean(gaps) * 1e3:.2f} ms over "
            f"{len(gaps)} gaps; all 8 at once, new tokens/s streamed "
            f"{', '.join(f'{r:.1f}' for r in rates['stream'])}, blocking "
            f"{', '.join(f'{r:.1f}' for r in rates['blocking'])} (in turns); "
            f"on {CARD}")

        # (b) the continuation splice, f32 at 2 layers
        url32 = served["ref32"][3]
        n_cut, n_all = _fleet_splice(url32, _prompt(rng, 40), 256)
        log(f"  (b) f32 2-layer: a stream cut after 10 events ({n_cut} of "
            f"{n_all} tokens), its slot freed, the continuation == the "
            "uncut stream token for token")

        # (c) the disaggregated handoff: bf16 full width, then f32. The
        # wire carries bf16 pages as f32: a GPT-small page is 4.7 MB of
        # blob, so one page (a 100-byte prompt: 64 tokens and 36) stays
        # under the 8 MiB body cap in base64; the f32 2-layer cut moves
        # 4 pages (300 bytes: 256 tokens and 44)
        hand16, hand32 = _prompt(rng, 100), _prompt(rng, 300)
        got16 = _fleet_handoff(served["prefill"][::3], served["decode"][::3],
                               hand16, 32, "bf16 GPT-small")
        ref16 = _call(url, "/v1/generate", {"prompt": hand16,
                                            "max_new_tokens": 32})[2]
        same16 = got16["completion"] == ref16["completions"][0]["completion"]
        got32 = _fleet_handoff(served["prefill32"][::3],
                               served["decode32"][::3], hand32, 32,
                               "f32 2-layer")
        want32 = _call(url32, "/v1/generate", {"prompt": hand32,
                                               "max_new_tokens": 32})[2]
        check(got32["completion"] == want32["completions"][0]["completion"],
              "phase 4g (c): the f32 decode server's tokens after the "
              "import differ from a server that imported nothing")
        log(f"  (c) f32: tokens == a server that imported nothing; bf16 "
            f"tokens {'equal' if same16 else 'differ from'} the main "
            "server's (not gated)")

        # (d) deadlines
        status, _, body = _call(url, "/v1/generate", {
            "prompt": "x" * 20, "max_new_tokens": 64, "deadline_ms": 1})
        check(status == 504 and "deadline" in body["error"],
              f"phase 4g (d): deadline_ms 1 answered {status}")
        t0 = time.perf_counter()
        events, done, _, _ = _sse(url, {"prompt": _prompt(rng, 20),
                                        "stream": True, "max_new_tokens": 900,
                                        "deadline_ms": 400})
        cut_s = time.perf_counter() - t0
        decoded = len(_ids(events))
        check(done and decoded > 0 and "deadline" in events[-1].get(
            "error", ""), "phase 4g (d): the in-slot deadline did not cut "
            f"the stream ({decoded} tokens, last event {events[-1:]})")
        check(_wait(lambda: _call(url, "/loadz")[2]["active"] == 0, 10),
              "phase 4g (d): /loadz active did not return to 0")
        with server._front.lock:
            _audit_pages(server._front.engine)
            expired = server._front.engine.stats["deadline_expired"]
        check(expired == 2, f"phase 4g (d): {expired} requests expired, "
              "expected 2")
        log(f"  (d) deadline_ms 1: 504; a 900-token stream under 400 ms cut "
            f"after {decoded} tokens at {cut_s * 1e3:.1f} ms with an error "
            "event; active 0, the page audit holds at depth 1")

        # (e) tenants
        _fleet_tenants(url, server)

        # (f) drain: in-flight requests finish, new ones get 503
        outs = []
        flight = [threading.Thread(target=lambda: outs.append(_call(
            url, "/v1/generate", {"prompt": _prompt(random.Random(i), 50),
                                  "max_new_tokens": 256})[0]))
            for i in range(4)]
        for t in flight:
            t.start()
        check(_wait(lambda: _call(url, "/loadz")[2]["active"] >= 1),
              "phase 4g (f): nothing got in flight")
        server.begin_drain()
        status, hdrs, body = _call(url, "/v1/generate", {"prompt": "late",
                                                         "max_new_tokens": 4})
        check(status == 503 and body.get("reason") == "draining"
              and hdrs["Retry-After"], f"phase 4g (f): a new request while "
              f"draining answered {status} {body}")
        load, live = _call(url, "/loadz")[2], _call(url, "/livez")
        check(load["draining"] is True and live[0] == 200
              and live[2]["live"] is True,
              f"phase 4g (f): /loadz {load['draining']} /livez {live}")
        for t in flight:
            t.join(600)
        check(outs == [200] * 4, f"phase 4g (f): in-flight requests "
              f"answered {outs}")
        check(server.drain(30), "phase 4g (f): the server did not drain")
        log("  (f) drain: 4 requests in flight finished (200), a new one got "
            "503 draining; /loadz draining true, /livez live true")

        # (g) the contract's key set, on every server
        for name, (_, _, _, u) in served.items():
            keys = set(_call(u, "/loadz")[2])
            check(keys == LOADZ_KEYS, f"phase 4g (g): /loadz of {name} has "
                  f"keys {sorted(keys ^ LOADZ_KEYS)} off the contract")
        status, _, stepz = _call(url, "/stepz?n=4")
        check(status == 200 and len(stepz["steps"]) == 4,
              "phase 4g (g): /stepz")
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t_drive
        launches = {name: getattr(mod, attr)
                    for name, (mod, attr) in counters.items()}
        variants = dict(pa.variant_launches)
        replays = graphs.replays
    finally:
        for entry in served.values():
            _unserve(*entry[:3])
        shutil.rmtree(b16, ignore_errors=True)
        shutil.rmtree(b32, ignore_errors=True)
    log(f"  (g) /loadz has the contract's 17 keys on all 6 servers; /stepz "
        "answers")
    log(f"  launches in 4g: {launches}; K1 by variant {variants}; decode "
        f"graph replays {replays}; set-up {setup_s:.1f} s, driven "
        f"{drive_s:.1f} s")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched in phase 4g")
    check(variants["decode"] > 0 and variants["chunk"] > 0,
          f"phase 4g: K1's decode and chunk variants did not both launch "
          f"({variants})")
    check(replays > 0, "phase 4g: no decode graph replayed")
    return launches


# -- phase 4h: the operator contract ------------------------------------------

ADMIN_TOKEN = "chip-smoke-admin"


def _hf_tokenizer_dir(path: Path, vocab: int = 512, seed: int = 0) -> str:
    """A byte-level BPE of at most ``vocab`` tokens trained on generated
    text, saved with ``save_pretrained`` (no download)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, \
        trainers
    from transformers import PreTrainedTokenizerFast

    rng = random.Random(seed)
    text = [_prompt(rng, 120) for _ in range(400)]
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(text, trainers.BpeTrainer(
        vocab_size=vocab, special_tokens=["<pad>", "<eos>", "<unk>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    PreTrainedTokenizerFast(
        tokenizer_object=tok, eos_token="<eos>", pad_token="<pad>",
        unk_token="<unk>").save_pretrained(str(path))
    return str(path)


def _traceparent(i: int) -> tuple:
    tid = f"{0x5eed0000 + i:032x}"
    return tid, f"00-{tid}-{0xab00 + i:016x}-01"


def _metric(url: str, name: str) -> float:
    """One unlabeled sample of ``/metrics``."""
    with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
        for line in resp.read().decode().splitlines():
            if line.startswith(name + " "):
                return float(line.split()[1])
    raise SmokeFailure(f"/metrics has no sample {name}")


def _greedy(url: str, prompts, new: int) -> list:
    """Each prompt alone (one admission route a request, so bf16 tokens
    compare exactly): the completions."""
    out = []
    for p in prompts:
        status, _, body = _call(url, "/v1/generate", {"prompt": p,
                                                      "max_new_tokens": new})
        check(status == 200, f"a greedy request answered {status} {body}")
        out.append(body["completions"][0]["completion"])
    return out


def _rescore(torch, model, seq, s_prompt: int, eos) -> float:
    """The length-penalised log-probability (alpha 1) of one beam's
    generated tokens under ``model``: up to and including the first eos,
    as the beam search scores it."""
    gen = seq[s_prompt:].tolist()
    n = gen.index(eos) + 1 if eos is not None and eos in gen else len(gen)
    ids = torch.tensor([seq[:s_prompt + n].tolist()], device=model.device)
    with torch.inference_mode():
        logp = torch.log_softmax(model(ids)[0].float(), dim=-1)
    pos = torch.arange(s_prompt - 1, s_prompt + n - 1, device=model.device)
    total = logp[pos, ids[0, pos + 1]].sum().item()
    return total / ((5.0 + n) / 6.0)


def _plain_model(torch, dev, bundle):
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLM
    from pyspark_tf_gke_tpu_torch.train.export import load_serving_bundle

    _, params, _ = load_serving_bundle(str(bundle), dev)
    with torch.device(dev):
        plain = CausalLM(_load_cfg(bundle), use_kernels=False)
    return plain.load_params(params).eval()


def _load_cfg(bundle):
    from pyspark_tf_gke_tpu_torch.train.export import config_from_dict

    return config_from_dict(json.loads(
        (Path(bundle) / "config.json").read_text())["config"])


@contextlib.contextmanager
def _uncounted(counters):
    """A reference computed on a served model beside the path (the
    servers idle meanwhile): every launch count, K1's variants and the
    graph replays are put back as they were on entry."""
    from pyspark_tf_gke_tpu_torch.ops import graphs
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    counts = {name: getattr(mod, attr)
              for name, (mod, attr) in counters.items()}
    variants, replays = dict(pa.variant_launches), graphs.replays
    try:
        yield
    finally:
        for name, (mod, attr) in counters.items():
            setattr(mod, attr, counts[name])
        pa.variant_launches.update(variants)
        graphs.replays = replays


def _beam_text(tokenizer, prompt: str, seq, s_prompt: int, eos) -> str:
    """The completion the server returns for one beam's sequence: the
    prompt and the decoded new tokens up to the first eos."""
    gen = seq[s_prompt:].tolist()
    if eos is not None and eos in gen:
        gen = gen[:gen.index(eos)]
    return prompt + tokenizer.decode(gen)


def _op_beams(torch, dev, served, b32, rng, counters):
    """(a): beam search over HTTP, bf16 at full width and the f32 cut.
    The references on the served models run outside the path's counts."""
    from pyspark_tf_gke_tpu_torch.models.beam_search import beam_search
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln

    server, url = served["main"][0], served["main"][3]
    prompts = [_prompt(rng, 64) for _ in range(4)]
    body = {"prompts": prompts, "max_new_tokens": 64, "num_beams": 4}
    k2, k3 = fa.launches, ln.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status, _, out = _call(url, "/v1/generate", body)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    check(status == 200, f"phase 4h (a): beams answered {status} {out}")
    check(fa.launches > k2 and ln.launches > k3,
          "phase 4h (a): beam search launched no K2f or K3")
    # the served model's own search on the same prompts must return the
    # HTTP completions; the plain model rescores those sequences
    ids = torch.tensor([list(p.encode()) for p in prompts])
    tok = server.tokenizer
    eos = tok.eos_id
    with _uncounted(counters):
        seqs, scores = beam_search(server.model, ids, 64, num_beams=4,
                                   eos_token_id=eos)
    plain = _plain_model(torch, dev, served["main"][4])
    worst = 0.0
    for i, entry in enumerate(out["completions"]):
        check(entry["completion"] == _beam_text(tok, prompts[i], seqs[i],
                                                64, eos),
              "phase 4h (a): an HTTP completion is not the served model's "
              "search's sequence")
        check(abs(entry["beam_score"] - scores[i].item()) < 1e-3,
              f"phase 4h (a): HTTP beam_score {entry['beam_score']} != the "
              f"server model's search {scores[i].item()}")
        ref = _rescore(torch, plain, seqs[i].cpu(), 64, eos)
        worst = max(worst, abs(entry["beam_score"] - ref))
    del plain
    check(worst <= 2e-2, f"phase 4h (a): bf16 beam_score against the plain "
          f"model's rescoring differs by {worst}")
    # f32: the served search == the plain search, sequences and scores
    url32, server32 = served["ref32"][3], served["ref32"][0]
    status, _, out32 = _call(url32, "/v1/generate", body)
    check(status == 200, f"phase 4h (a): f32 beams answered {status}")
    plain32 = _plain_model(torch, dev, b32)
    want, want_sc = beam_search(plain32, ids, 64, num_beams=4,
                                eos_token_id=eos)
    del plain32
    with _uncounted(counters):
        got, got_sc = beam_search(server32.model, ids, 64, num_beams=4,
                                  eos_token_id=eos)
    check(torch.equal(got.cpu(), want.cpu()), "phase 4h (a): f32 beam "
          "sequences with kernels != use_kernels=False")
    err32 = (got_sc - want_sc).abs().max().item()
    for i, entry in enumerate(out32["completions"]):
        check(entry["completion"] == _beam_text(server32.tokenizer,
                                                prompts[i], want[i], 64, eos),
              "phase 4h (a): an f32 HTTP completion != use_kernels=False")
        err32 = max(err32, abs(entry["beam_score"] - want_sc[i].item()))
    check(err32 <= 1e-5, f"phase 4h (a): f32 beam scores differ by {err32}")
    ms_tok = beam_s * 1e3 / 64
    log(f"  (a) beams 4, 4 prompts of 64 tokens, 64 new tokens: bf16 "
        f"{ms_tok:.2f} ms a new token ({beam_s:.2f} s over HTTP; the dense "
        f"cache reordered every step), completions == the served model's "
        f"search, beam_score vs the plain model's rescoring within "
        f"{worst:.2e}; f32 2-layer: HTTP and kernel sequences == "
        f"use_kernels=False, scores within {err32:.1e}; on {CARD}")
    return ms_tok


def _op_reload(torch, dev, served, bundles, rng):
    """(b): a hot swap under 8 open streams, the generation, the swapped
    tokens against fresh servers, 409, the two rollbacks."""
    from pyspark_tf_gke_tpu_torch.chaos import inject

    server, url = served["main"][0], served["main"][3]
    admin = {"X-Admin-Token": ADMIN_TOKEN}
    # 8 streams open, then the reload
    results = [None] * 8

    def stream(i):
        results[i] = _sse(url, {"prompt": _prompt(random.Random(40 + i), 60),
                                "stream": True, "max_new_tokens": 200})

    flight = [threading.Thread(target=stream, args=(i,)) for i in range(8)]
    for t in flight:
        t.start()
    check(_wait(lambda: _call(url, "/loadz")[2]["active"] >= 8, 60),
          "phase 4h (b): the 8 streams never all got slots")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status, _, rel = _call(url, "/admin/reload",
                           {"bundle": str(bundles["b16_2"]), "generation": 2},
                           headers=admin)
    reload_s = time.perf_counter() - t0
    check(status == 200 and rel["bundle_generation"] == 2,
          f"phase 4h (b): reload answered {status} {rel}")
    for t in flight:
        t.join(600)
    ended = 0
    for events, done, _, _ in results:
        terminals = [e for e in events if e.get("done") or "error" in e]
        check(done and len(terminals) == 1,
              f"phase 4h (b): a stream across the reload had "
              f"{len(terminals)} terminals (done {done})")
        last = terminals[0]
        check(last.get("done") or "reload" in last.get("error", ""),
              f"phase 4h (b): a stream ended with {last}")
        ended += bool(last.get("done"))
    for path in ("/healthz", "/loadz"):
        check(_call(url, path)[2]["bundle_generation"] == 2,
              f"phase 4h (b): {path} does not read generation 2")
    t0 = time.perf_counter()
    check(_call(url, "/v1/generate", {"prompt": "first after", 
                                      "max_new_tokens": 16})[0] == 200,
          "phase 4h (b): the first request after the reload failed")
    first_s = time.perf_counter() - t0
    # the swapped server's tokens against a fresh one on bundle 2
    prompts = [_prompt(rng, n) for n in (30, 90, 180, 400)]
    fresh = _serve_bundle(torch, dev, bundles["b16_2"])
    try:
        same16 = _greedy(url, prompts, 32) == _greedy(fresh[3], prompts, 32)
    finally:
        _unserve(*fresh[:3])
    check(same16, "phase 4h (b): bf16 tokens after the reload differ from "
          "a fresh server's on bundle 2")
    url32 = served["ref32"][3]
    check(_call(url32, "/admin/reload", {"bundle": str(bundles["b32_2"]),
                                         "generation": 2},
                headers=admin)[0] == 200, "phase 4h (b): f32 reload")
    fresh = _serve_bundle(torch, dev, bundles["b32_2"])
    try:
        same32 = _greedy(url32, prompts, 32) == _greedy(fresh[3], prompts, 32)
    finally:
        _unserve(*fresh[:3])
    check(same32, "phase 4h (b): f32 tokens after the reload differ from a "
          "fresh server's on bundle 2")
    # 409 while one is in flight (the second reload goes back to bundle 1)
    holder = {}
    t = threading.Thread(target=lambda: holder.update(r=_call(
        url, "/admin/reload", {"bundle": str(bundles["b16"]),
                               "generation": 3}, headers=admin)))
    t.start()
    check(_wait(server._reload_lock.locked, 30),
          "phase 4h (b): the second reload never started")
    status, _, body = _call(url, "/admin/reload",
                            {"bundle": str(bundles["b16"])}, headers=admin)
    t.join(600)
    check(status == 409, f"phase 4h (b): a reload during a reload answered "
          f"{status} {body}")
    check(holder["r"][0] == 200 and holder["r"][2]["bundle_generation"] == 3,
          f"phase 4h (b): the second reload answered {holder['r']}")
    before = _greedy(url, prompts[:2], 16)
    # a load that keeps failing: nothing swaps
    inject.install(inject.ChaosInjector.from_spec("bundle.load:fail%1x3"))
    try:
        status, _, body = _call(url, "/admin/reload",
                                {"bundle": str(bundles["b16_2"])},
                                headers=admin)
    finally:
        inject.uninstall()
    check(status == 502 and body["rolled_back"] is False
          and body["bundle_generation"] == 3,
          f"phase 4h (b): a failing load answered {status} {body}")
    # a canary that raises (its admission): the swap rolls back, and the
    # engine it built and dropped leaves nothing allocated behind it
    mem_pre = _allocated(torch, dev)
    inject.install(inject.ChaosInjector.from_spec("engine.admit:fail@1"))
    try:
        status, _, body = _call(url, "/admin/reload",
                                {"bundle": str(bundles["b16_2"])},
                                headers=admin)
    finally:
        inject.uninstall()
    check(status == 502 and body["rolled_back"] is True
          and body["bundle_generation"] == 3,
          f"phase 4h (b): a failing canary answered {status} {body}")
    check(_greedy(url, prompts[:2], 16) == before
          and _call(url, "/loadz")[2]["bundle_generation"] == 3,
          "phase 4h (b): after the rollbacks the old generation does not "
          "serve its tokens")
    mem_post = _allocated(torch, dev)  # the rebuilt engine's graphs taken
    check(abs(mem_post - mem_pre) <= 0.05 * mem_pre,
          f"phase 4h (b): allocated memory {mem_post / 2**20:.1f} MiB after "
          f"the failing canary's rollback against {mem_pre / 2**20:.1f} MiB "
          f"before it")
    log(f"  (b) reload under 8 open streams: {ended}/8 streams finished "
        f"with their tokens, the others 503 reloading, each exactly one "
        f"terminal; wall {reload_s:.2f} s (load {rel['timings_s']['load']:.2f}, "
        f"drain + swap {rel['timings_s']['swap']:.2f}, canary "
        f"{rel['timings_s']['canary']:.2f}: the new engine's first step and "
        f"its graph capture); the first request after it {first_s * 1e3:.1f} "
        f"ms; generation 2 on /healthz and /loadz; tokens == a fresh "
        f"server's on bundle 2 (bf16 and f32); a reload in flight: 409; a "
        f"failing load: 502 nothing swapped; a failing canary: 502 rolled "
        f"back, generation 3 serves as before, allocated "
        f"{mem_pre / 2**20:.1f} -> {mem_post / 2**20:.1f} MiB "
        f"({100 * (mem_post - mem_pre) / mem_pre:+.2f}%) across it; on "
        f"{CARD}")
    return reload_s, rel["timings_s"], first_s


def _op_profile(torch, served, rng, out_dir: Path):
    """(c): /admin/profile over 4 busy steps under traffic."""
    url = served["main"][3]
    admin = {"X-Admin-Token": ADMIN_TOKEN}
    status, _, armed = _call(url, "/admin/profile",
                             {"steps": 4, "output_dir": str(out_dir)},
                             headers=admin)
    check(status == 202 and armed["armed"],
          f"phase 4h (c): /admin/profile answered {status} {armed}")
    status, _, _ = _call(url, "/admin/profile", {"steps": 4}, headers=admin)
    check(status == 409, f"phase 4h (c): a second capture while armed "
          f"answered {status}")
    outs = []
    flight = [threading.Thread(target=lambda i=i: outs.append(_call(
        url, "/v1/generate", {"prompt": _prompt(random.Random(60 + i), 80),
                              "max_new_tokens": 96})[0])) for i in range(8)]
    for t in flight:
        t.start()
    for t in flight:
        t.join(600)
    check(outs == [200] * 8, f"phase 4h (c): traffic answered {outs}")

    def written():
        evs = _call(url, "/events?n=50")[2]["events"]
        return [e for e in evs if e["kind"] == "profile_trace_written"]

    check(_wait(lambda: bool(written()), 60),
          "phase 4h (c): no profile_trace_written event")
    ev = written()[-1]
    check(ev["step_seq_last"] - ev["step_seq_first"] >= 3
          and ev["trace_file"], f"phase 4h (c): the event is {ev}")
    text = Path(ev["trace_file"]).read_text()
    check("paged_decode" in text, "phase 4h (c): the written Chrome trace "
          "names no K1 decode kernel")
    log(f"  (c) /admin/profile steps 4: 202, a second one 409; the Chrome "
        f"trace ({len(text) / 1e6:.1f} MB) covers steps "
        f"{ev['step_seq_first']}..{ev['step_seq_last']} with "
        f"{len(ev['trace_ids'])} trace ids and names K1's decode kernel")


def _op_watchdog(torch, dev, b32, hb: Path):
    """(d): one device step held 2 s under --step-timeout 0.5 (the f32
    2-layer cut: its graph capture stays far inside the timeout)."""
    from pyspark_tf_gke_tpu_torch.chaos import inject
    from pyspark_tf_gke_tpu_torch.obs.metrics import MetricsRegistry

    wd = _serve_bundle(torch, dev, b32, live_stall_s=1.0,
                       heartbeat_file=str(hb), registry=MetricsRegistry())
    server, url = wd[0], wd[3]
    front = server._front
    try:
        prompt = _prompt(random.Random(7), 50)
        before = _greedy(url, [prompt], 48)
        beat0 = json.loads(hb.read_text())["step"]
        front.step_timeout_s = 0.5  # armed after the warm-up's capture
        http_reply = {}

        def ask():
            status, _, body = _call(url, "/v1/generate", {
                "prompt": _prompt(random.Random(70), 40),
                "max_new_tokens": 600})
            http_reply.update(status=status, body=body,
                              t=time.perf_counter())

        asker = threading.Thread(target=ask)
        asker.start()
        rids = [front.submit(list(_prompt(random.Random(71 + i),
                                          40).encode()), 600)
                for i in range(3)]
        check(_wait(lambda: _call(url, "/loadz")[2]["active"] == 4, 10),
              "phase 4h (d): the 4 waiters never all got slots")
        # the next device step holds the driver loop (and its lock) 2 s
        inject.install(inject.ChaosInjector.from_spec(
            "engine.device_step:hang@1:2"))
        t_hold = time.perf_counter()
        waits = []

        def waiter(rid):
            try:
                front.wait(rid, timeout_s=60)
                waits.append(("ok", time.perf_counter() - t_hold))
            except RuntimeError as exc:
                waits.append((str(exc), time.perf_counter() - t_hold))

        try:
            ws = [threading.Thread(target=waiter, args=(r,)) for r in rids]
            for w in ws:
                w.start()
            time.sleep(1.3)  # inside the hold, past --live-stall 1
            live_status, _, live = _call(url, "/livez")
            for w in ws:
                w.join(60)
            asker.join(60)
        finally:
            inject.uninstall()
        check(live_status == 503 and live["wedged"],
              f"phase 4h (d): /livez during the wedge: {live_status} {live}")
        for what, wait_s in waits:
            check("step_timeout" in what and wait_s <= 0.5 + 0.125 + 0.3,
                  f"phase 4h (d): a waiter got {what!r} after {wait_s:.3f} "
                  "s of the hold")
        http_s = http_reply["t"] - t_hold
        check(http_reply["status"] == 500
              and "step_timeout" in http_reply["body"]["error"]
              and http_s < 2.5, f"phase 4h (d): the HTTP waiter got "
              f"{http_reply['status']} after {http_s:.2f} s")
        check(_wait(lambda: _metric(url, "serve_engine_rebuilds_total") >= 1,
                    10), "phase 4h (d): the engine did not rebuild")
        after = _greedy(url, [prompt], 48)
        graphs_n = front.stats()["decode_graphs"]
        reaps = _metric(url, "serve_step_watchdog_reaps_total")
        beat1 = json.loads(hb.read_text())["step"]
    finally:
        _unserve(*wd[:3])
    check(after == before, "phase 4h (d): greedy tokens after the rebuild "
          "differ from before the wedge")
    check(graphs_n >= 1 and reaps >= 1 and beat1 > beat0,
          f"phase 4h (d): graphs {graphs_n}, reaps {reaps}, heartbeat "
          f"{beat0} -> {beat1}")
    log(f"  (d) --step-timeout 0.5, one device step held 2 s with 4 requests "
        f"in flight: 3 waiters got EngineWedged "
        f"{', '.join(f'{w:.3f}' for _, w in sorted(waits))} s into the hold, "
        f"the HTTP one 500 at {http_s:.2f} s; /livez 503 wedged during the "
        f"hold; rebuilt, graphs recaptured ({graphs_n}), tokens == before; "
        f"reaps {reaps:g}, heartbeat step {beat0} -> {beat1}")


def _op_obs(torch, served, rng):
    """(e): /metrics counters, /traces, the runtime gauges, traced
    against untraced tokens/s."""
    server, url = served["main"][0], served["main"][3]
    names = ("serve_requests_total", "serve_generate_requests_total",
             "serve_generate_tokens_total")
    before = {n: _metric(url, n) for n in names}
    tids, tokens = [], 0
    for i in range(8):
        tid, tp = _traceparent(i)
        status, hdrs, body = _call(url, "/v1/generate", {
            "prompt": _prompt(rng, 40), "max_new_tokens": 24},
            headers={"traceparent": tp})
        check(status == 200 and hdrs["X-Request-Id"] == tid,
              f"phase 4h (e): X-Request-Id {hdrs['X-Request-Id']} != {tid}")
        tokens += body["completions"][0]["new_tokens"]
        tids.append(tid)
    after = {n: _metric(url, n) for n in names}
    check(after["serve_requests_total"] - before["serve_requests_total"] == 8
          and after["serve_generate_requests_total"]
          - before["serve_generate_requests_total"] == 8
          and after["serve_generate_tokens_total"]
          - before["serve_generate_tokens_total"] == tokens,
          f"phase 4h (e): /metrics moved {before} -> {after}, the phase "
          f"sent 8 requests for {tokens} tokens")
    for tid in tids:
        got = _call(url, f"/traces?trace_id={tid}")[2]["traces"]
        check(len(got) == 1, f"phase 4h (e): /traces has {len(got)} traces "
              f"for {tid}")
        names_ = [e["name"] for e in got[0]["spans"][0]["events"]]
        check(names_[:2] == ["queue_wait", "admission"]
              and names_[-1] == "terminal",
              f"phase 4h (e): a trace's events are {names_}")
    live = _metric(url, "runtime_live_array_bytes")
    check(live > 0, "phase 4h (e): runtime_live_array_bytes is 0")
    rates = {"traced": [], "untraced": []}
    for _ in range(2):
        for mode, sample in (("traced", 1.0), ("untraced", 0.0)):
            server.tracer.sample = sample
            outs = []
            flight = [threading.Thread(target=lambda i=i: outs.append(_call(
                url, "/v1/generate", {"prompt": _prompt(
                    random.Random(90 + i), 60), "max_new_tokens": 128})[2]))
                for i in range(8)]
            t0 = time.perf_counter()
            for t in flight:
                t.start()
            for t in flight:
                t.join(600)
            dt = time.perf_counter() - t0
            rates[mode].append(sum(o["completions"][0]["new_tokens"]
                                   for o in outs) / dt)
    server.tracer.sample = 1.0
    # after a reload the canary's tenant makes the first client a second
    # one: DWRR on, batched admission off (as in the JAX server)
    fair = server._front.stats()["fair_active"]
    log(f"  (e) /metrics requests +8, generate requests +8, tokens +{tokens} "
        f"== the phase's own; /traces: one trace per X-Request-Id, each "
        f"queue_wait, admission .. terminal; runtime_live_array_bytes "
        f"{live:.0f}; 8 requests x 128 new tokens, new tokens/s traced "
        f"(sample 1.0) {', '.join(f'{r:.1f}' for r in rates['traced'])}, "
        f"untraced (0.0) {', '.join(f'{r:.1f}' for r in rates['untraced'])} "
        f"(in turns; not gated; the engine's fair_active {fair}) on "
        f"{CARD}")
    return rates


def _op_hf(torch, dev, root: Path):
    """(f): a bundle whose tokenizer is a local Hugging Face directory."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import init_params
    from pyspark_tf_gke_tpu_torch.train.export import export_serving_bundle

    tok_dir = _hf_tokenizer_dir(root / "hf_tokenizer")
    cfg = dataclasses.replace(_serving_cfg(), num_layers=2)
    bundle = root / "chip_smoke_hf_bundle"
    export_serving_bundle(cfg, init_params(cfg, seed=3), str(bundle),
                          tokenizer_spec=tok_dir)
    hf = _serve_bundle(torch, dev, bundle)
    try:
        prompt = "paged attention on hopper"
        status, _, body = _call(hf[3], "/v1/generate", {
            "prompt": prompt, "max_new_tokens": 24})
        tok = hf[0].tokenizer
    finally:
        _unserve(*hf[:3])
        shutil.rmtree(bundle, ignore_errors=True)
    entry = body["completions"][0] if status == 200 else body
    check(status == 200 and entry["completion"].startswith(prompt)
          and isinstance(entry["completion"], str),
          f"phase 4h (f): the HF-tokenizer bundle answered {status} {entry}")
    check(tok.decode(tok.encode(prompt)) == prompt,
          "phase 4h (f): the tokenizer does not round-trip")
    log(f"  (f) a bundle naming a local BPE tokenizer ({tok.vocab_size} "
        f"tokens, save_pretrained): /v1/generate decodes "
        f"{entry['new_tokens']} new tokens")


def run_operator_contract(torch, dev, counters=None):
    """Phase 4h: the replica's operator contract. Phase 4's bundle
    (GPT-small, bf16, int8 export) behind ``BundleServer`` with an admin
    token, a fresh registry and event trail, and every request traced;
    the f32 gates on the same width cut to 2 layers. (a) beam search;
    (b) hot reload under open streams, 409, rollbacks; (c)
    ``/admin/profile``; (d) the step watchdog; (e) ``/metrics``,
    ``/traces``, the runtime gauges, traced against untraced tokens/s;
    (f) a Hugging Face tokenizer bundle. Then the card's allocated memory
    after two more reloads against its level before them. Every
    count is set to 0 before (a) and read after (f). Returns the launches
    by kernel."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import init_params
    from pyspark_tf_gke_tpu_torch.obs.events import EventLog
    from pyspark_tf_gke_tpu_torch.obs.metrics import MetricsRegistry
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa
    from pyspark_tf_gke_tpu_torch.ops import graphs
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa
    from pyspark_tf_gke_tpu_torch.train.export import export_serving_bundle

    if counters is None:
        counters = _serve_counters()
    t_phase = time.perf_counter()
    cfg = _serving_cfg()
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype=torch.float32)
    root = PORT_PKG / "_build" / "chip_smoke_ops"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    bundles = {"b16": root / "b16", "b16_2": root / "b16_2",
               "b32": root / "b32", "b32_2": root / "b32_2"}
    for name, c, seed in (("b16", cfg, 0), ("b16_2", cfg, 5),
                          ("b32", cfg32, 1), ("b32_2", cfg32, 6)):
        export_serving_bundle(c, init_params(c, seed=seed),
                              str(bundles[name]), quantize=c is cfg,
                              extra_meta={"pipeline_generation": 1})
    served = {}
    try:
        served["main"] = _serve_bundle(
            torch, dev, bundles["b16"], admin_token=ADMIN_TOKEN,
            registry=MetricsRegistry(), trace_sample=1.0, trace_slow_ms=0.0,
            event_log=EventLog(str(root / "events.jsonl")))
        served["main"] += (bundles["b16"],)
        raw0 = _allocated(torch, dev)
        served["ref32"] = _serve_bundle(torch, dev, bundles["b32"],
                                        admin_token=ADMIN_TOKEN,
                                        registry=MetricsRegistry())
        setup_s = time.perf_counter() - t_phase
        rng = random.Random(8)
        torch.cuda.synchronize()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        for variant in pa.variant_launches:
            pa.variant_launches[variant] = 0
        graphs.replays = 0
        t_drive = time.perf_counter()
        beam_ms = _op_beams(torch, dev, served, bundles["b32"], rng,
                           counters)
        reload = _op_reload(torch, dev, served, bundles, rng)
        _op_profile(torch, served, rng, root / "profile")
        _op_watchdog(torch, dev, bundles["b32"], root / "heartbeat.json")
        rates = _op_obs(torch, served, rng)
        _op_hf(torch, dev, root)
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t_drive
        launches = {name: getattr(mod, attr)
                    for name, (mod, attr) in counters.items()}
        variants = dict(pa.variant_launches)
        replays = graphs.replays
        _unserve(*served.pop("ref32")[:3])
        mem0, mem2 = _reload_memory(torch, dev, served, bundles)
    finally:
        for entry in served.values():
            _unserve(*entry[:3])
        shutil.rmtree(root, ignore_errors=True)
    check(abs(mem2 - mem0) <= 0.05 * mem0,
          f"phase 4h: allocated memory {mem2 / 2**20:.1f} MiB after the "
          f"reloads against {mem0 / 2**20:.1f} MiB after the first warm-up")
    log(f"  allocated on the card, the main server alone: {mem0 / 2**20:.1f} "
        f"MiB after a warm-up, {mem2 / 2**20:.1f} MiB after two more reloads "
        f"({100 * (mem2 - mem0) / mem0:+.2f}%); {raw0 / 2**20:.1f} MiB at "
        f"the phase's first warm-up (not compared: other servers' threads "
        f"come and go in between, each cuBLAS handle with its workspaces)")
    log(f"  launches in 4h: {launches}; K1 by variant {variants}; decode "
        f"graph replays {replays}; set-up {setup_s:.1f} s, driven "
        f"{drive_s:.1f} s")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched in phase 4h")
    check(replays > 0, "phase 4h: no decode graph replayed")
    return launches, {"beam_ms_per_token": beam_ms, "reload_s": reload[0],
                      "reload_timings_s": reload[1],
                      "first_after_reload_s": reload[2], "rates": rates}


def _allocated(torch, dev) -> int:
    """Bytes allocated on the card after a collection (an engine's graphs
    hold their engine in a reference cycle)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(dev)


def _reload_memory(torch, dev, served, bundles):
    """The card's allocated memory after a warm-up against its level
    after two more reloads, each followed by a request that recaptures
    the graphs: only the main server is up and only its driver thread
    runs cuBLAS, so the workspaces cuBLAS keeps for each thread's handle
    (for the process's life) are the same at both readings."""
    url = served["main"][3]
    admin = {"X-Admin-Token": ADMIN_TOKEN}
    prompt = [_prompt(random.Random(5), 40)]
    _greedy(url, prompt, 16)
    mem0 = _allocated(torch, dev)
    for key, gen in (("b16_2", 4), ("b16", 5)):
        status, _, body = _call(url, "/admin/reload",
                                {"bundle": str(bundles[key]),
                                 "generation": gen}, headers=admin)
        check(status == 200, f"phase 4h: reload answered {status} {body}")
        _greedy(url, prompt, 16)
    return mem0, _allocated(torch, dev)

# -- phase 4i: int8 weights resident -----------------------------------------


def _reckoned_bytes(model, meta) -> int:
    """What a model loaded from a bundle should hold: each quantized
    path's int8 elements and f32 scales (one a kernel column, one a table
    row), every other leaf at the dtype the model stores it in."""
    qpaths = set(meta.get("quantized_paths", []))
    total = 0
    for path, p in model.flax_parameters().items():
        if path in qpaths:
            scales = p.shape[1] if path.endswith("/kernel") else p.shape[0]
            total += p.numel() + 4 * scales
        else:
            total += p.numel() * p.element_size()
    return total


def check_resident(torch, dev):
    """Phase 4i: phase 4's GPT-small weights (numpy seed 0) exported with
    int8 weights and with ``quantize=False``, each loaded on the card.
    The int8 load's allocated bytes lie within 5% of the reckoned int8
    elements + f32 scales + unquantized leaves, and every quantized path
    is an int8 parameter (no float copy). Prints both loads' MiB and the
    16-step, 8-slot decode chunk's device time (profiler) of each, with
    its Dense layers' share (K6 or cuBLAS). Returns the int8 chunk's
    profiled ``(wall ms, device ms)``."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import init_params
    from pyspark_tf_gke_tpu_torch.train.export import (export_serving_bundle,
                                                       load_serving_bundle)

    cfg = _serving_cfg()
    params = init_params(cfg, seed=0)
    chunks = {}
    for name, quantize in (("int8", True), ("bf16", False)):
        bundle = PORT_PKG / "_build" / f"chip_smoke_{name}_bundle"
        export_serving_bundle(cfg, params, str(bundle), quantize=quantize)
        torch.cuda.empty_cache()
        before = _allocated(torch, dev)
        model, _, meta = load_serving_bundle(str(bundle), dev)
        held = _allocated(torch, dev) - before
        shutil.rmtree(bundle, ignore_errors=True)
        want = _reckoned_bytes(model, meta)
        qpaths = meta["quantized_paths"]
        own = model.flax_parameters()
        floats = [p for p in qpaths if own[p].dtype != torch.int8]
        log(f"  {name} bundle loaded: {held / 2**20:.1f} MiB allocated, "
            f"reckoned {want / 2**20:.1f} MiB ({len(qpaths)} int8 paths); "
            f"{CARD}")
        if quantize:
            check(len(qpaths) == 2 + 6 * cfg.num_layers + 1 and not floats,
                  f"quantized paths held as float: {floats[:4]}")
            check(abs(held - want) <= 0.05 * want,
                  f"the int8 load holds {held} bytes, reckoned {want}")
        chunks[name] = profile_engine(torch, model, label=f"{name} paged")
        del model, own
    log(f"  decode chunk device time int8 / bf16 weights: "
        f"{chunks['int8'][1][1]:.2f} / {chunks['bf16'][1][1]:.2f} ms; Dense "
        f"layers K6 {chunks['int8'][2][0]:.3f} ms against cuBLAS "
        f"{chunks['bf16'][2][1]:.3f} ms; a kernel running "
        f"{chunks['int8'][1][2]:.2f} / {chunks['bf16'][1][2]:.2f} ms; the "
        f"graph replayed alone "
        f"{chunks['int8'][3]:.3f} / {chunks['bf16'][3]:.3f} ms; {CARD}")
    return chunks["int8"][1]


# -- phase 4j: the dense slot-cache engine ------------------------------------


def _engine_tokens(torch, model, traffic, **kw):
    """Tokens of ``traffic`` through a fresh engine of ``model`` (8 slots,
    chunk 16 unless given) and the engine."""
    from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine

    eng = ContinuousEngine(model, **{"num_slots": 8, "chunk": 16, **kw})
    return _run_traffic(eng, traffic)[0], eng


def _dense_f32_gates(torch, dev):
    """Phase 4j's f32 gates on GPT-small's width cut to 2 layers, int8
    weights: the engine's greedy tokens equal ``generate``'s (with the
    kernels and with ``use_kernels=False``); the prefix LRU, warmed with
    a 512-token system prompt, hits every request and gives the cache-off
    tokens; pieces of 256 give the unchunked tokens."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig,
                                                           generate,
                                                           init_params)
    from pyspark_tf_gke_tpu_torch.ops.quant import quantize_tree
    from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine

    cfg = CausalLMConfig(num_layers=2, dtype=torch.float32)
    params = quantize_tree(init_params(cfg, seed=1))
    rng = random.Random(5)
    prompts = [[rng.randrange(cfg.vocab_size) for _ in range(n)]
               for n in (20, 100, 300, 700, 5, 50)]
    model = None
    for use_kernels in (True, False):
        with torch.device(dev):
            model = CausalLM(cfg, use_kernels=use_kernels)
        model.load_params(params).eval()
        got, _ = _engine_tokens(torch, model, [
            dict(prompt_ids=p, max_new_tokens=24) for p in prompts])
        want = [generate(model, [p], 24)[0, len(p):].tolist()
                for p in prompts]
        _first_divergence(torch, model, prompts, got, want,
                          f"f32 dense engine (use_kernels={use_kernels}) "
                          "against generate")
    log(f"  (c) f32 2-layer int8 dense engine == generate for "
        f"{len(prompts)} prompts, with the kernels and without")
    system = [rng.randrange(cfg.vocab_size) for _ in range(512)]
    shared = [dict(prompt_ids=system + [rng.randrange(cfg.vocab_size)
                                        for _ in range(32)],
                   max_new_tokens=16) for _ in range(8)]
    off, _ = _engine_tokens(torch, model, shared, num_slots=4, chunk=8)
    eng = ContinuousEngine(model, num_slots=4, chunk=8, prefix_cache_size=4)
    eng.warm_prefix(system)
    on = _run_traffic(eng, shared)[0]
    pc = eng.stats["prefix_cache"]
    computed = eng.stats["prefill_tokens_computed"]
    check(on == off, "dense prefix-cache hits changed the tokens")
    check(pc["hits"] == len(shared) and pc["misses"] == 0
          and computed == 512 + 32 * len(shared),
          f"prefix cache {pc}, {computed} prefill tokens computed")
    log(f"  (c) f32 dense --prefix-cache 4 warmed with 512 tokens: "
        f"{pc['hits']} hits, {computed} prefill tokens computed "
        f"(512 + {len(shared)} x 32), tokens == cache off")
    long = [dict(prompt_ids=[rng.randrange(cfg.vocab_size)
                             for _ in range(n)], max_new_tokens=16)
            for n in (1000, 64, 600, 64)]
    whole, _ = _engine_tokens(torch, model, long)
    pieces, eng = _engine_tokens(torch, model, long, prefill_chunk=256,
                                 step_token_budget=384)
    check(pieces == whole, "dense chunked prefill changed the tokens")
    check(eng.stats["prefill_chunks"] >= 4 + 3,
          f"{eng.stats['prefill_chunks']} prefill pieces")
    log(f"  (c) f32 dense --prefill-chunk 256: "
        f"{eng.stats['prefill_chunks']} pieces, tokens == unchunked")


def _dense_spec(torch, dev, pair):
    """Phase 4j: the trained cb --spec pair exported dense with int8
    weights: speculation (k = 5, the draft bundle) gives spec off's
    tokens in f32."""
    from pyspark_tf_gke_tpu_torch.models.layers import flax_tree
    from pyspark_tf_gke_tpu_torch.train.export import (export_serving_bundle,
                                                       load_serving_bundle)
    from pyspark_tf_gke_tpu_torch.train.spec_fixture import _pack_rows

    loaded = []
    for name, m in zip(("target", "draft"), pair):
        bundle = PORT_PKG / "_build" / f"chip_smoke_dense_{name}"
        export_serving_bundle(m.cfg, flax_tree(m), str(bundle),
                              quantize=True)
        loaded.append(load_serving_bundle(str(bundle), dev)[0])
        shutil.rmtree(bundle, ignore_errors=True)
    target, draft = loaded
    check(not target.cfg.paged_kv and target.lm_head.kernel.dtype
          == torch.int8, "the spec target is not a dense int8 model")
    prompts = [p.tolist() for p in _pack_rows(
        SPEC["plen"], n_rows=SPEC["requests"], seed=5, skew=SPEC["skew"])]
    traffic = [dict(prompt_ids=p, max_new_tokens=SPEC["new"])
               for p in prompts]
    kw = dict(num_slots=SPEC["slots"], chunk=SPEC["chunk"],
              adaptive_chunk=True)
    off, _ = _engine_tokens(torch, target, traffic, **kw)
    on, eng = _engine_tokens(torch, target, traffic, spec_tokens=SPEC["k"],
                             draft_model=draft, **kw)
    _first_divergence(torch, target, prompts, on, off,
                      "f32 dense int8 spec against spec off")
    log(f"  (c) the trained pair exported dense int8: spec on (k = "
        f"{SPEC['k']}) == off for {len(traffic)} requests, accept rate "
        f"{eng.stats['spec']['accept_rate']}")


def run_dense_serving(torch, dev, counters, pair, paged_chunk):
    """Phase 4j: a dense GPT-small bundle (no ``kv_num_pages``, int8
    weights, numpy seed 0) served by ``BundleServer --continuous-slots 8``
    over HTTP with phase 4's traffic: every request completes, K6, K3 and
    K2f launch and K1 does not, the engine's two 16-step decode chunks
    are captured graphs and replay; the replayed dense chunk's device
    time beside the paged one's (``paged_chunk``, phase 4i); bf16's share
    of greedy tokens identical to the paged engine on the same weights;
    then the f32 gates and the trained pair. Returns the HTTP run's
    launches."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig,
                                                           init_params)
    from pyspark_tf_gke_tpu_torch.models.layers import flax_tree
    from pyspark_tf_gke_tpu_torch.ops import graphs
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa
    from pyspark_tf_gke_tpu_torch.train.export import export_serving_bundle
    from pyspark_tf_gke_tpu_torch.train.serve import (BundleServer,
                                                      start_http_server)

    t0 = time.perf_counter()
    cfg = CausalLMConfig()
    bundle = PORT_PKG / "_build" / "chip_smoke_dense_bundle"
    export_serving_bundle(cfg, init_params(cfg, seed=0), str(bundle),
                          quantize=True)
    server = BundleServer(str(bundle), device=str(dev), continuous_slots=8,
                          continuous_chunk=16)
    httpd = start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        _post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 2})
        _post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 2,
                                     "temperature": 0.8, "seed": 1})
        torch.cuda.synchronize()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        replays0 = graphs.replays
        jobs = _phase4_jobs(random.Random(0))
        results, errors = [None] * len(jobs), []

        def client(idx):
            for j in range(idx, len(jobs), 3):
                try:
                    results[j] = _post(url + "/v1/generate", jobs[j])
                except Exception as exc:  # noqa: BLE001 — reported below
                    errors.append(f"request {j}: {exc}")

        t_start = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(900)
        wall = time.perf_counter() - t_start
        torch.cuda.synchronize()
        launches = {name: getattr(mod, attr)
                    for name, (mod, attr) in counters.items()}
        replays = graphs.replays - replays0
        stats = server._front.engine.stats
        model = server.model
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        thread.join(30)
        shutil.rmtree(bundle, ignore_errors=True)
    check(not errors, "; ".join(errors))
    new = 0
    for body, res in zip(jobs, results):
        check(res is not None and res[0] == 200, f"dense generate: {res}")
        comp = res[1]["completions"][0]
        check(comp["completion"].startswith(body["prompt"])
              and 0 <= comp["new_tokens"] <= body["max_new_tokens"],
              f"malformed dense completion {comp}")
        new += comp["new_tokens"]
    check("paged" not in stats and stats["decode_graphs"] == 2,
          f"dense engine stats: decode_graphs {stats['decode_graphs']}, "
          f"paged {'paged' in stats}")
    check(replays > 0, "the dense decode chunk did not replay its graph")
    for name, n in launches.items():
        if name == "paged_attention":
            check(n == 0, f"K1 launched {n} times on the dense path")
        else:
            check(n > 0, f"kernel {name} was not launched on the dense path")
    log(f"  (c) dense GPT-small over HTTP (8 slots, chunk 16): {new} new "
        f"tokens in {wall:.3f} s = {new / wall:.1f} tokens/s, {replays} "
        f"graph replays; launches {launches}; served in "
        f"{time.perf_counter() - t0:.1f} s; on {CARD}")
    _, dense_chunk, *_ = profile_engine(torch, model, label="int8 dense")
    log(f"  (c) replayed 16-step 8-slot decode chunk, device time: dense "
        f"{dense_chunk[1]:.2f} ms, paged {paged_chunk[1]:.2f} ms (4i); "
        f"{CARD}")
    with torch.device(dev):
        paged = CausalLM(_serving_cfg())
    paged.load_params(flax_tree(model)).eval()
    rng = random.Random(6)
    traffic = [dict(prompt_ids=[rng.randrange(cfg.vocab_size)
                                for _ in range(n)], max_new_tokens=32)
               for n in (20, 100, 300, 700) * 2]
    dense_toks, _ = _engine_tokens(torch, model, traffic)
    paged_toks, _ = _engine_tokens(torch, paged, traffic)
    log(f"  (c) bf16 greedy tokens identical, dense against paged on the "
        f"same weights: {_identical_share(dense_toks, paged_toks):.4f}")
    del model, paged
    _dense_f32_gates(torch, dev)
    _dense_spec(torch, dev, pair)
    return launches


# -- phase 6: the training main path ------------------------------------------

CORPUS_WORDS = ("flash", "attention", "kernel", "hopper", "gradient",
                "layer", "norm", "token", "train", "step", "batch", "loss",
                "adam", "warp", "shared", "memory", "the", "a", "of", "and")


def write_corpus(root: Path, docs: int = 1200, seed: int = 0) -> str:
    """A seeded synthetic corpus: sentences of words from a fixed list,
    blank-line-separated documents of 60-120 words (~600 KB, ~1100 rows
    of 512 bytes: past lm_pretrain's 256-row shuffle buffer)."""
    rng = random.Random(seed)
    root.mkdir(parents=True, exist_ok=True)
    for f in range(4):
        parts = []
        for _ in range(docs // 4):
            words = [rng.choice(CORPUS_WORDS)
                     for _ in range(rng.randint(60, 120))]
            parts.append(" ".join(words) + ".")
        (root / f"part-{f}.txt").write_text("\n\n".join(parts) + "\n")
    return str(root / "*.txt")


TRAIN_FLAGS = ["--seq-len", "512", "--batch-size", "16",
               "--compute-dtype", "bfloat16", "--learning-rate", "3e-4",
               "--epochs", "2", "--steps-per-epoch", "10", "--seed", "0"]


def run_training(torch, dev, counters):
    from pyspark_tf_gke_tpu_torch.models.causal_lm import generate
    from pyspark_tf_gke_tpu_torch.train.export import load_serving_bundle
    from pyspark_tf_gke_tpu_torch.train.lm_pretrain import main as lm_main

    work = PORT_PKG / "_build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    pattern = write_corpus(work / "corpus")
    bundle = work / "bundle"
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    history = lm_main(["--data-pattern", pattern, *TRAIN_FLAGS,
                       "--output-dir", str(work / "run"),
                       "--export-bundle", str(bundle), "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    losses = history["loss"]
    log(f"  lm_pretrain 2 epochs x 10 steps in {wall:.1f} s (model init, "
        f"data, training, checkpoint and int8 export)")
    for key in ("loss", "next_token_accuracy", "step_time_ms",
                "examples_per_sec"):
        log(f"  {key}: {history[key]}")
    tokens_s = [e * 512 for e in history["examples_per_sec"]]
    log(f"  tokens/s: {tokens_s}")
    log(f"  kernel launches on the training path (20 steps): {launches}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(losses[1] < losses[0], f"epoch-2 mean loss {losses[1]} is not "
          f"below epoch 1's {losses[0]}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the training path")
    model, _, meta = load_serving_bundle(str(bundle), device=str(dev))
    out = generate(model, [list(b"the flash kernel ")], 16)
    text = bytes(t for t in out[0].tolist() if t < 256).decode(
        "utf-8", "replace")
    check(out.shape == (1, 33) and out.device.type == "cuda",
          f"generate from the exported bundle gave {tuple(out.shape)}")
    log(f"  exported bundle ({'int8' if meta['quantized'] else 'dense'}) "
        f"generates on the card: {text!r}")
    shutil.rmtree(work, ignore_errors=True)
    return launches, history


def _train_model(torch, dev, cfg, seed, use_kernels=True):
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLM, init_params

    with torch.device(dev):
        model = CausalLM(cfg, use_kernels=use_kernels,
                         param_dtype=torch.float32)
    return model.load_params(init_params(cfg, seed=seed))


def _lm_batch(torch, dev, cfg, b, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"input_ids": torch.randint(0, cfg.vocab_size,
                                       (b, cfg.max_seq_len), generator=g,
                                       device=dev, dtype=torch.int32)}


def profile_training(torch, dev):
    """Two steady full-width training steps under ``torch.profiler``:
    host wall against device-busy time, and the top device ops."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLMConfig
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    cfg = CausalLMConfig(vocab_size=259, max_seq_len=512)
    trainer = Trainer(_train_model(torch, dev, cfg, 0),
                      TASKS["causal_lm"](), tx=make_optimizer(3e-4))
    state = trainer.init_state()
    batch = _lm_batch(torch, dev, cfg, 16, 7)
    for _ in range(3):
        trainer.step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        trainer.step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 5
    log(f"  5 steady steps without the profiler: {step_ms:.2f} ms/step, "
        f"{16 * 512 / step_ms * 1e3:.0f} tokens/s")
    wall, busy, top = _profiled(
        torch, lambda: [trainer.step(state, batch) for _ in range(2)])
    if busy <= 0:
        log(f"  2 steps: wall {wall:.2f} ms; device time not visible to "
            "torch.profiler")
        return
    log(f"  2 steps under the profiler: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%), idle "
        f"{100 * (1 - busy / wall):.1f}%")
    for name, ms in top[:10]:
        log(f"    {ms:9.3f} ms  {name[:90]}")


# -- phase 7: training parity on the card -------------------------------------


def _grads(torch, model, batch):
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS

    task = TASKS["causal_lm"]()
    loss, _ = task.loss_and_metrics(task.forward(model, batch), batch)
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _grad_diff(torch, got, want):
    """Relative L2 error of the whole gradient tree, and the tensor with
    the largest error relative to max(its norm, 1e-3 x the largest
    tensor norm): some gradients are zero up to rounding (a key bias
    shifts every score of a row equally), and their relative error is
    noise."""
    num = sum(float(((got[n] - want[n]) ** 2).sum()) for n in want)
    den = sum(float((want[n] ** 2).sum()) for n in want)
    floor = 1e-3 * max(float(w.norm()) for w in want.values())
    rels = {n: float((got[n] - want[n]).norm()) / max(float(want[n].norm()),
                                                      floor, 1e-30)
            for n in want}
    worst = max(rels, key=rels.get)
    return math.sqrt(num / max(den, 1e-30)), worst, rels[worst]


def check_training_parity(torch, dev):
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLMConfig
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    # f32, 2 layers at the full width: kernels against use_kernels=False
    # from one init. Both compute every product in f32 (TF32 is off), so
    # they differ by summation order: step-0 gradients within 1e-4
    # relative L2 (the whole tree, and each tensor on its own) and losses
    # within 1e-4 over 3 Adam steps.
    cfg = CausalLMConfig(vocab_size=259, max_seq_len=512, num_layers=2,
                         dtype=torch.float32)
    batches = [_lm_batch(torch, dev, cfg, 8, 10 + i) for i in range(3)]
    runs = {}
    for use_kernels in (True, False):
        model = _train_model(torch, dev, cfg, 3, use_kernels)
        _, g0 = _grads(torch, model, batches[0])
        trainer = Trainer(model, TASKS["causal_lm"](),
                          tx=make_optimizer(3e-4))
        state = trainer.init_state()
        losses = [float(trainer.step(state, b)[1]["loss"]) for b in batches]
        runs[use_kernels] = (g0, losses)
    rel, worst, worst_rel = _grad_diff(torch, runs[True][0], runs[False][0])
    dloss = max(abs(a - b) for a, b in zip(runs[True][1], runs[False][1]))
    log(f"  f32 2-layer: losses kernels {runs[True][1]} vs plain "
        f"{runs[False][1]} (max diff {dloss:.2e}, tolerance 1e-4); step-0 "
        f"gradients relative L2 {rel:.2e}, worst tensor {worst} "
        f"{worst_rel:.2e} (tolerance 1e-4 each)")
    check(dloss <= 1e-4 and rel <= 1e-4 and worst_rel <= 1e-4,
          "f32 training through the kernels disagrees with plain")

    # bf16 at full width: the kernels round P and dS to bf16 where the
    # TPU kernels do and keep the LayerNorm statistics in f32, rounding
    # each output once, while the plain path's autograd
    # rounds the probabilities and every intermediate product to bf16
    # (as its forward does: 2e-2 on the prefill logits); through 12 layers of
    # backward allow 5e-2 relative L2 over the whole gradient tree. The
    # tree's norm is dominated by the embedding, head and MLP, so each
    # tensor is held on its own too: the worst read 1.96e-2 on an H100
    # (layer 11's key kernel), allow 1e-1 — a wrong attention or
    # LayerNorm gradient in any layer is off by O(1). The step-0 loss (an
    # f32 mean over 8192 tokens of bf16 logits) read 3e-5 apart: allow
    # 1e-3.
    cfg = CausalLMConfig(vocab_size=259, max_seq_len=512)
    batch = _lm_batch(torch, dev, cfg, 16, 20)
    loss_k, gk = _grads(torch, _train_model(torch, dev, cfg, 4), batch)
    loss_p, gp = _grads(torch, _train_model(torch, dev, cfg, 4, False), batch)
    rel, worst, worst_rel = _grad_diff(torch, gk, gp)
    log(f"  full-width bf16 step-0: loss kernels {loss_k:.5f} vs plain "
        f"{loss_p:.5f} (diff {abs(loss_k - loss_p):.2e}, tolerance 1e-3); "
        f"gradients relative L2 {rel:.2e} (tolerance 5e-2); worst tensor "
        f"{worst} {worst_rel:.2e} (tolerance 1e-1)")
    check(all(bool(torch.isfinite(g).all()) for g in gk.values()),
          "non-finite bf16 gradient")
    check(abs(loss_k - loss_p) <= 1e-3,
          "bf16 loss through the kernels disagrees")
    check(rel <= 5e-2 and worst_rel <= 1e-1,
          "bf16 gradients through the kernels disagree")


def check_wide_lm_step(torch, dev, counters):
    """GPT-2 large's widths (hidden 1280, 20 heads of 64, FFN 5120; the
    JAX package trains them with ``lm_pretrain --hidden-size 1280
    --num-heads 20``), 2 layers, bf16, batch 4 x 128: step-0 loss and
    gradients through the kernels (K3 and K3b at D = 1280) against
    ``use_kernels=False`` from one init under phase 7's bf16 limits, then
    one Adam step through the ``Trainer``. Every LayerNorm counter must
    move. Returns the launches."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLMConfig
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    cfg = CausalLMConfig(vocab_size=259, max_seq_len=128, hidden_size=1280,
                         num_layers=2, num_heads=20, intermediate_size=5120)
    batch = _lm_batch(torch, dev, cfg, 4, 30)
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    model = _train_model(torch, dev, cfg, 5)
    loss_k, gk = _grads(torch, model, batch)
    trainer = Trainer(model, TASKS["causal_lm"](), tx=make_optimizer(3e-4))
    state = trainer.init_state()
    step_loss = float(trainer.step(state, batch)[1]["loss"])
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    loss_p, gp = _grads(torch, _train_model(torch, dev, cfg, 5, False), batch)
    rel, worst, worst_rel = _grad_diff(torch, gk, gp)
    log(f"  hidden 1280, 20 heads, 2 layers, bf16, 4 x 128: loss kernels "
        f"{loss_k:.5f} vs plain {loss_p:.5f} (diff {abs(loss_k - loss_p):.2e}"
        f", tolerance 1e-3); gradients relative L2 {rel:.2e} (tolerance "
        f"5e-2); worst tensor {worst} {worst_rel:.2e} (tolerance 1e-1); "
        f"Adam step loss {step_loss:.5f}; launches {launches}")
    check(all(bool(torch.isfinite(g).all()) for g in gk.values())
          and math.isfinite(step_loss), "non-finite hidden-1280 step")
    check(abs(loss_k - loss_p) <= 1e-3,
          "hidden-1280 loss through the kernels disagrees")
    check(rel <= 5e-2 and worst_rel <= 1e-1,
          "hidden-1280 gradients through the kernels disagree")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched at hidden 1280")
    return launches


def check_d128_lm(torch, dev, counters):
    """Phase 7c: a Llama-width head (``lm_pretrain --hidden-size 1024
    --num-heads 8``: 8 heads of 128, FFN 4096; depth cut to 2 layers,
    bf16, batch 4 x 512): step-0 loss and gradients through the kernels
    (K2f, K2dq and K2dkv on the tensor cores at D 128) against
    ``use_kernels=False`` from one init under phase 7's bf16 limits, then
    one Adam step; every training kernel's counter must move. Then a
    paged bundle of the same widths is served over HTTP (4 slots) for
    three greedy requests: prefill through K2f at D 128, decode through
    K1's decode variant at D 128; and an f32 copy's engine must give the
    dense ``generate``'s tokens. Returns ``(training launches, serving
    launches)``."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig,
                                                           generate,
                                                           init_params)
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa
    from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
    from pyspark_tf_gke_tpu_torch.train.export import export_serving_bundle
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.serve import (BundleServer,
                                                      start_http_server)
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    cfg = CausalLMConfig(vocab_size=259, max_seq_len=512, hidden_size=1024,
                         num_layers=2, num_heads=8, intermediate_size=4096)
    check(cfg.head_dim == 128
          and fa.flash_plan(cfg.head_dim, cfg.dtype).design == "wgmma",
          "the phase-7c model does not run the D-128 tensor-core kernels")
    batch = _lm_batch(torch, dev, cfg, 4, 40)
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    model = _train_model(torch, dev, cfg, 6)
    loss_k, gk = _grads(torch, model, batch)
    trainer = Trainer(model, TASKS["causal_lm"](), tx=make_optimizer(3e-4))
    state = trainer.init_state()
    step_loss = float(trainer.step(state, batch)[1]["loss"])
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    loss_p, gp = _grads(torch, _train_model(torch, dev, cfg, 6, False), batch)
    rel, worst, worst_rel = _grad_diff(torch, gk, gp)
    log(f"  hidden 1024, 8 heads of 128, 2 layers, bf16, 4 x 512: loss "
        f"kernels {loss_k:.5f} vs plain {loss_p:.5f} (diff "
        f"{abs(loss_k - loss_p):.2e}, tolerance 1e-3); gradients relative "
        f"L2 {rel:.2e} (tolerance 5e-2); worst tensor {worst} "
        f"{worst_rel:.2e} (tolerance 1e-1); Adam step loss "
        f"{step_loss:.5f}; launches {launches}")
    check(all(bool(torch.isfinite(g).all()) for g in gk.values())
          and math.isfinite(step_loss), "non-finite D-128 step")
    check(abs(loss_k - loss_p) <= 1e-3,
          "D-128 loss through the kernels disagrees")
    check(rel <= 5e-2 and worst_rel <= 1e-1,
          "D-128 gradients through the kernels disagree")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched at head_dim 128")
    del model, trainer, state, gk, gp

    serve_cfg = dataclasses.replace(cfg, kv_page_size=64, kv_num_pages=32)
    bundle = PORT_PKG / "_build" / "chip_smoke_d128_bundle"
    export_serving_bundle(serve_cfg, init_params(serve_cfg, seed=2),
                          str(bundle), quantize=True)
    server = BundleServer(str(bundle), device=str(dev), continuous_slots=4,
                          continuous_chunk=8)
    httpd = start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = random.Random(3)
    serve_counters = _serve_counters()
    try:
        # warm-up: the server's engine captures its greedy and its
        # sampled 16-step decode chunk here (the only sizes this
        # server dispatches: a fixed chunk, no budget, no adaptive)
        _post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 2})
        _post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 2,
                                     "temperature": 0.8, "seed": 1})
        torch.cuda.synchronize()
        for mod, attr in serve_counters.values():
            setattr(mod, attr, 0)
        decode0 = pa.variant_launches["decode"]
        body = {"prompts": [_prompt(rng, n) for n in (30, 150, 400)],
                "max_new_tokens": 24}
        res = _post(url + "/v1/generate", body)
        torch.cuda.synchronize()
        served = {name: getattr(mod, attr)
                  for name, (mod, attr) in serve_counters.items()}
        decode = pa.variant_launches["decode"] - decode0
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        thread.join(30)
        shutil.rmtree(bundle, ignore_errors=True)
    check(res[0] == 200 and len(res[1]["completions"]) == 3,
          f"D-128 generate failed: {res}")
    for prompt, comp in zip(body["prompts"], res[1]["completions"]):
        check(comp["completion"].startswith(prompt)
              and 0 <= comp["new_tokens"] <= 24,
              f"malformed D-128 completion {comp}")
    log(f"  D-128 bundle served 3 greedy requests: new tokens "
        f"{[c['new_tokens'] for c in res[1]['completions']]}; launches "
        f"{served}, K1 decode variant {decode}")
    for name, n in served.items():
        check(n > 0, f"kernel {name} was not launched serving head_dim 128")
    check(decode == served["paged_attention"] and decode > 0,
          "K1 at head_dim 128 did not run its decode variant")

    cfg32 = dataclasses.replace(serve_cfg, dtype=torch.float32)
    with torch.device(dev):
        m32 = CausalLM(cfg32)
    m32.load_params(init_params(cfg32, seed=2)).eval()
    prompts = [[rng.randrange(256) for _ in range(n)] for n in (20, 100, 300)]
    eng = ContinuousEngine(m32, num_slots=4, chunk=8)
    rids = {eng.submit(p, max_new_tokens=16): p for p in prompts}
    got = dict(eng.run_until_drained())
    for rid, p in rids.items():
        ref = generate(m32, [p], 16)[0, len(p):].tolist()
        check(got[rid] == ref, f"D-128 f32 engine tokens {got[rid]} != "
              f"generate {ref} (prompt {len(p)} tokens)")
    log("  D-128 f32 engine greedy tokens == dense generate for 3 prompts "
        "(16 tokens each)")
    return launches, served


# -- phases 7d and 7e: BERT-base fine-tuning ----------------------------------

# BERT-base (the JAX bert_finetune defaults: vocab 30522, hidden 768, 12
# layers, 12 heads, FFN 3072) at seq 128, global batch 32, bf16; Adam at
# 1e-4 (the JAX default 2e-5 moves a random init too little in 20 steps
# to show the loss fall)
BERT_SEQ, BERT_BATCH, BERT_VOCAB = 128, 32, 30522
BERT_FLAGS = ["--seq-len", str(BERT_SEQ), "--batch-size", str(BERT_BATCH),
              "--compute-dtype", "bfloat16", "--learning-rate", "1e-4",
              "--seed", "0"]


# -- phase 6c: the rest of the LM training plane ---------------------------------

# GPT-2's vocabulary size: the width --vocab-chunks exists for
LM_PLANE_VOCAB = 50257
LM_PLANE_FLAGS = ["--data-format", "tokens", "--seq-len", "512",
                  "--batch-size", "16", "--compute-dtype", "bfloat16",
                  "--learning-rate", "1e-2", "--steps-per-epoch", "10",
                  "--seed", "0", "--vocab-chunks", "8",
                  "--async-checkpoint", "--checkpoint-every-steps", "5"]
# the chunked loss against the dense f32-logit loss: the loss sums the
# same bf16 products in f32 (another order); the gradients' products take
# the logit gradient rounded to bf16 (phase 3d's bf16 rule, relative L2)
CE_LOSS_ATOL = 1e-3
CE_ARGMAX_AGREE = 0.999
CE_GRAD_REL_L2 = 1e-2
# LAMB / Adafactor on the card against the CPU, of each leaf's largest
# value (f32 formulas, reductions summed in another order)
OPT_REL = 1e-5
OPT_SHAPES = {"layer_0/attention/query/kernel": (768, 768),
              "layer_0/mlp_in/kernel": (768, 3072),
              "layer_0/mlp_in/bias": (3072,),
              "ln_final/scale": (768,), "wpe/embedding": (512, 768),
              "conv/kernel": (3, 3, 128, 256), "small/kernel": (64, 100)}


def _wordlevel_tokenizer_dir(path: Path, vocab: int = LM_PLANE_VOCAB) -> str:
    """A WordLevel tokenizer of exactly ``vocab`` tokens (``<pad>``,
    ``<eos>``, ``<unk>`` and the words ``w0``...), split on whitespace,
    saved with ``save_pretrained`` (no download)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    specials = ["<pad>", "<eos>", "<unk>"]
    words = specials + [f"w{i}" for i in range(vocab - len(specials))]
    tok = Tokenizer(models.WordLevel(
        vocab={w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(
        tokenizer_object=tok, eos_token="<eos>", pad_token="<pad>",
        unk_token="<unk>").save_pretrained(str(path))
    return str(path)


def _zipf_docs(n: int, seed: int, vocab: int = LM_PLANE_VOCAB) -> list:
    """Documents of 60-120 words ``w{k}`` with Zipf-distributed ``k``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n):
        # the tail folds back over the words (no clipped spike)
        ks = (rng.zipf(1.2, rng.integers(60, 121)) - 1) % (vocab - 3)
        docs.append(" ".join(f"w{k}" for k in ks))
    return docs


def write_token_corpus(root: Path, tokenizer: str, seq_len: int = 512,
                       docs: int = 2400, shards: int = 4) -> str:
    """Token shards of a seeded Zipf corpus through the port's text
    bridge (the executor body of each partition, then the sidecar);
    returns the shards' glob."""
    from pyspark_tf_gke_tpu_torch.etl.text_bridge import (
        tokenize_partition_docs, write_shard_metadata)

    root.mkdir(parents=True, exist_ok=True)
    prefix = str(root / "lm")
    corpus = _zipf_docs(docs, seed=0)
    for i in range(shards):
        list(tokenize_partition_docs(i, corpus[i::shards], prefix, seq_len,
                                     tokenizer_spec=tokenizer,
                                     num_shards=shards))
    write_shard_metadata(prefix, seq_len, tokenizer_spec=tokenizer)
    return f"{prefix}-*.tfrecord"


def _train_total() -> float:
    from pyspark_tf_gke_tpu_torch.obs.metrics import platform_families

    return platform_families()["train_steps_total"].value


def _lm_plane_cli(torch, dev, counters, work: Path, tok: str, shards: str):
    """(a): the token-shard CLI with chunked CE, Adafactor and async
    checkpoints, its resume, and a LAMB run."""
    from pyspark_tf_gke_tpu_torch.train.checkpoint import CheckpointManager
    from pyspark_tf_gke_tpu_torch.train.lm_pretrain import main as lm_main

    run, bundle = work / "run", work / "bundle"
    base = ["--data-pattern", shards, "--tokenizer", tok, *LM_PLANE_FLAGS,
            "--device", str(dev)]
    _reset(torch, counters)
    steps_before = _train_total()
    t0 = time.perf_counter()
    history = lm_main(base + ["--optimizer", "adafactor", "--weight-decay",
                              "0.01", "--epochs", "2", "--output-dir",
                              str(run), "--export-bundle", str(bundle)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _moved(counters)
    losses = history["loss"]
    log(f"  lm_pretrain tokens + vocab chunks 8 + adafactor + async "
        f"checkpoints, 2 x 10 steps in {wall:.1f} s (model init, shards, "
        f"training, checkpoints, int8 export)")
    for key in ("loss", "next_token_accuracy", "step_time_ms",
                "examples_per_sec"):
        log(f"  {key}: {history[key]}")
    log(f"  step time at vocab {LM_PLANE_VOCAB}: {history['step_time_ms']}"
        f" ms ({CARD})")
    log(f"  kernel launches (20 steps): {launches}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(losses[1] < losses[0], f"epoch-2 mean loss {losses[1]} is not "
          f"below epoch 1's {losses[0]}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by lm_pretrain")
    steps = _train_total() - steps_before
    check(steps == 20, f"train_steps_total moved by {steps}, not 20")
    on_disk = CheckpointManager(str(run / "checkpoints")).all_steps()
    check(on_disk == [10, 20], f"checkpoint steps on disk {on_disk}")
    for path in (run / "history.json", run / "checkpoints" / "history.json"):
        check(json.loads(path.read_text()) == history,
              f"{path.name} under {path.parent.name} is not the run's")
    lm_main(base + ["--optimizer", "adafactor", "--weight-decay", "0.01",
                    "--epochs", "1", "--output-dir", str(run), "--resume"])
    notes = (run / "causal-lm.txt").read_text()
    check("final step: 30" in notes, "--resume did not continue the step "
          "count from 20 to 30")
    lamb = lm_main(base + ["--optimizer", "lamb", "--weight-decay", "0.01",
                           "--epochs", "1", "--output-dir",
                           str(work / "lamb")])
    check(all(math.isfinite(v) for v in lamb["loss"]),
          f"lamb: non-finite loss {lamb['loss']}")
    log(f"  resume: step 20 -> 30; lamb: loss {lamb['loss']}, "
        f"{lamb['step_time_ms']} ms/step")
    return launches, history, bundle


def _checkpoint_stall(torch, dev, work: Path):
    """The host time of one step after a synchronous, an asynchronous or
    no save of the GPT-small state at vocab 50257 (Adafactor, chunked
    loss), in turns; returns each mode's median ms."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig,
                                                           init_params)
    from pyspark_tf_gke_tpu_torch.train.checkpoint import CheckpointManager
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import Trainer, causal_lm_task

    cfg = CausalLMConfig(vocab_size=LM_PLANE_VOCAB, max_seq_len=512,
                         dtype=torch.bfloat16)
    with torch.device(dev):
        model = CausalLM(cfg, param_dtype=torch.float32)
    model.load_params(init_params(cfg, seed=0))
    trainer = Trainer(model, causal_lm_task(8),
                      tx=make_optimizer(1e-2, optimizer="adafactor"))
    state = trainer.init_state()
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"input_ids": torch.randint(0, LM_PLANE_VOCAB, (16, 512),
                                        generator=g, device=dev)}
    managers = {mode: CheckpointManager(str(work / f"stall-{mode}"),
                                        async_save=mode == "async")
                for mode in ("sync", "async")}
    times = {"none": [], "sync": [], "async": []}
    for _ in range(2):
        trainer.step(state, batch)  # warm-up
    for mode in ("none", "sync", "async", "async", "sync", "none") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode != "none":
            managers[mode].save(state, force=True)
        trainer.step(state, batch)
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - t0) * 1e3)
        if mode == "async":
            managers[mode].wait()  # the write ends outside the clock
    for m in managers.values():
        m.close()
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"  a step after no save / a synchronous / an asynchronous save "
        f"(state {sum(p.numel() for p in state.params.values()) / 1e6:.1f}M "
        f"params + Adafactor): {med['none']:.1f} / {med['sync']:.1f} / "
        f"{med['async']:.1f} ms (runs {times}); stall sync "
        f"{med['sync'] - med['none']:.1f}, async "
        f"{med['async'] - med['none']:.1f} ms ({CARD})")
    return med


def check_chunked_ce(torch, dev, b=16, s=512, e=768, v=LM_PLANE_VOCAB,
                     chunks=8):
    """(b): ``chunked_cross_entropy`` against the dense f32-logit loss
    on the trainer's operands (bf16 hidden states, the f32 head kernel
    cast to bf16, an f32 bias); prints each path's peak memory and ms."""
    import torch.nn.functional as F

    from pyspark_tf_gke_tpu_torch.ops.chunked_ce import chunked_cross_entropy

    n = b * (s - 1)
    g = torch.Generator(device=dev).manual_seed(0)
    hidden = torch.randn(n, e, generator=g, device=dev).to(torch.bfloat16)
    master = torch.randn(e, v, generator=g, device=dev) * 0.02
    bias = torch.randn(v, generator=g, device=dev) * 0.02
    labels = torch.randint(0, v, (n,), generator=g, device=dev)

    def leaves():
        return [t.detach().clone().requires_grad_()
                for t in (hidden, master, bias)]

    def chunked(h, k, bb):
        loss, amax = chunked_cross_entropy(h, k.to(torch.bfloat16), bb,
                                           labels, chunks)
        return loss, amax

    def dense(h, k, bb):
        logits = h.float() @ k.to(torch.bfloat16).float() + bb
        return F.cross_entropy(logits, labels, reduction="none"), \
            logits.argmax(-1)

    results, peaks, times = {}, {}, {}
    for name, fn in (("dense", dense), ("chunked", chunked)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        h, k, bb = leaves()
        loss, amax = fn(h, k, bb)
        loss.mean().backward()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated(dev) - base
        results[name] = (loss.detach(), amax, h.grad, k.grad, bb.grad)
        del h, k, bb, loss, amax

        def step(fn=fn):
            h, k, bb = leaves()
            fn(h, k, bb)[0].mean().backward()

        times[name] = cuda_ms(step, warmup=1, iters=3, reps=3)
        wall, busy, top = _profiled(torch, step)
        log(f"  {name} loss + backward profiled: wall {wall:.2f} ms, device "
            f"busy {busy:.2f} ms; top: " + ", ".join(
                f"{k[:40]} {ms:.2f}" for k, ms in top[:6]))
    (dl, da, dh, dk, db), (cl, ca, ch, ck, cb) = (results["dense"],
                                                  results["chunked"])
    loss_err = float((cl - dl).abs().max())
    agree = float((ca.long() == da).float().mean())
    acc = [float((a.long() == labels).float().mean()) for a in (da, ca)]
    rel = {name: float((x.float() - y.float()).norm()
                       / y.float().norm().clamp_min(1e-30))
           for name, x, y in (("hidden", ch, dh), ("kernel", ck, dk),
                              ("bias", cb, db))}
    log(f"  chunked CE ({chunks} chunks) vs dense f32 logits, N={n} E={e} "
        f"V={v} bf16: loss max_abs_err {loss_err:.3e} (tolerance "
        f"{CE_LOSS_ATOL}); argmax agreement {agree:.6f} (>= "
        f"{CE_ARGMAX_AGREE}), accuracy {acc[1]:.6f} vs {acc[0]:.6f}; "
        f"gradients relative L2 {rel} (tolerance {CE_GRAD_REL_L2})")
    log(f"  peak allocated over loss + backward: dense {peaks['dense'] / 2**20:.1f} MiB, "
        f"chunked {peaks['chunked'] / 2**20:.1f} MiB; loss + backward "
        f"dense {times['dense']:.3f} ms, chunked {times['chunked']:.3f} ms "
        f"({CARD})")
    check(loss_err <= CE_LOSS_ATOL and bool(torch.isfinite(cl).all()),
          f"chunked loss off the dense loss by {loss_err}")
    check(agree >= CE_ARGMAX_AGREE, f"argmax agreement {agree}")
    for name, r in rel.items():
        check(r <= CE_GRAD_REL_L2, f"chunked CE d{name} relative L2 {r}")
    check(peaks["chunked"] <= peaks["dense"] - 2**30,
          f"chunked peak {peaks['chunked']} B is not 1 GiB below the "
          f"dense {peaks['dense']} B")
    return {"peaks": peaks, "ms": times}


def check_optimizers_on_card(torch, dev):
    """(c): five LAMB and Adafactor updates (weight decay, clipping,
    warmup_cosine) of a flax-shaped tree on the card against the CPU."""
    import numpy as np

    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer

    rng = np.random.default_rng(0)
    params = {k: rng.normal(0, 0.05, s).astype(np.float32)
              for k, s in OPT_SHAPES.items()}
    grads = [{k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in OPT_SHAPES.items()} for _ in range(5)]
    for name in ("lamb", "adafactor"):
        out = {}
        for where in ("cpu", dev):
            tx = make_optimizer(1e-2, optimizer=name, weight_decay=0.01,
                                grad_clip_norm=1.0,
                                schedule="warmup_cosine", warmup_steps=2,
                                total_steps=10)
            p = {k: torch.tensor(v, device=where) for k, v in params.items()}
            st = tx.init(p)
            for gr in grads:
                tx.update({k: torch.tensor(v, device=where)
                           for k, v in gr.items()}, st, p)
            out[str(where)] = {k: t.cpu() for k, t in p.items()}
        worst = max(float((out[str(dev)][k] - out["cpu"][k]).abs().max()
                          / out["cpu"][k].abs().max()) for k in params)
        log(f"  {name}: 5 updates on the card vs the CPU, worst error of a "
            f"leaf's largest value {worst:.2e} (tolerance {OPT_REL})")
        check(worst <= OPT_REL, f"{name} on the card disagrees with the CPU")


def run_lm_eval(torch, dev, counters, bundle: Path, tok: str, work: Path):
    """(d): ``lm_eval`` in bundle mode on the card, then against a
    ``BundleServer`` on the card."""
    from pyspark_tf_gke_tpu_torch.evaluate.lm_eval import main as eval_main

    heldout = work / "heldout"
    heldout.mkdir(parents=True, exist_ok=True)
    (heldout / "part-0.txt").write_text("\n\n".join(_zipf_docs(64, 9)) + "\n")
    pattern = str(heldout / "*.txt")
    _reset(torch, counters)
    t0 = time.perf_counter()
    greedy = eval_main(["--bundle", str(bundle), "--data-pattern", pattern,
                        "--batches", "2", "--batch-size", "8", "--prompt",
                        "w1 w2 w3", "--max-new-tokens", "16", "--device",
                        str(dev)])
    beams = eval_main(["--bundle", str(bundle), "--prompt", "w4 w1",
                       "--max-new-tokens", "16", "--num-beams", "4",
                       "--device", str(dev)])
    torch.cuda.synchronize()
    launches = _moved(counters)
    log(f"  lm_eval on the int8 bundle in {time.perf_counter() - t0:.1f} s: "
        f"perplexity {greedy['perplexity']:.2f} over {greedy['tokens']} "
        f"tokens; greedy {greedy['samples'][0]['completion'][:80]!r}; "
        f"4 beams {beams['samples'][0]['completion'][:80]!r} (score "
        f"{beams['samples'][0]['beam_score']:.3f}); launches {launches}")
    check(math.isfinite(greedy["perplexity"]) and greedy["quantized"],
          f"lm_eval perplexity {greedy.get('perplexity')}")
    for out in (greedy, beams):
        check(out["samples"][0]["completion"].startswith(
            out["samples"][0]["prompt"]), "a sample did not decode")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by lm_eval")
    server, httpd, thread, url = _serve_bundle(torch, dev, bundle)
    try:
        remote = eval_main(["--endpoint", url, "--data-pattern", pattern,
                            "--batches", "1", "--batch-size", "4",
                            "--prompt", "w7 w8", "--max-new-tokens", "8"])
    finally:
        _unserve(server, httpd, thread)
    log(f"  lm_eval --endpoint: mean NLL {remote['mean_nll']:.4f} over "
        f"{remote['tokens']} tokens, sample "
        f"{remote['samples'][0]['completion'][:60]!r}")
    check(math.isfinite(remote["mean_nll"]) and remote["tokens"] > 0,
          f"lm_eval --endpoint mean NLL {remote.get('mean_nll')}")
    return launches


def _lm_eval_counters():
    """The kernels ``lm_eval`` runs on an int8 bundle: K3 and K2f (the
    perplexity forward, the prompts' prefill) and K6 (the decode loop)."""
    serve = _serve_counters()
    return {k: serve[k] for k in ("layernorm", "flash_attention_fwd",
                                  "int8_matmul")}


def run_lm_plane(torch, dev):
    """Phase 6c; returns the CLI's and ``lm_eval``'s launches and the
    measurements."""
    from pyspark_tf_gke_tpu_torch.data.text import get_tokenizer

    work = PORT_PKG / "_build" / "chip_smoke_lm_plane"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    tok = _wordlevel_tokenizer_dir(work / "tokenizer")
    check(get_tokenizer(tok).vocab_size == LM_PLANE_VOCAB,
          "the WordLevel tokenizer's vocabulary is not 50257")
    shards = write_token_corpus(work / "shards", tok)
    log(f"  tokenizer and token shards in {time.perf_counter() - t0:.1f} s")
    launches, history, bundle = _lm_plane_cli(torch, dev, _train_counters(),
                                              work, tok, shards)
    torch.cuda.empty_cache()
    stall = _checkpoint_stall(torch, dev, work)
    torch.cuda.empty_cache()
    ce = check_chunked_ce(torch, dev)
    torch.cuda.empty_cache()
    check_optimizers_on_card(torch, dev)
    eval_launches = run_lm_eval(torch, dev, _lm_eval_counters(), bundle,
                                tok, work)
    shutil.rmtree(work, ignore_errors=True)
    log(f"  phase 6c took {time.perf_counter() - t0:.1f} s")
    return launches, eval_launches, {"stall_ms": stall, **ce}


def write_bert_shards(root: Path, n: int = 1024, seed: int = 0) -> str:
    """ETL-bridge shards written by the port's writer from a numpy seed:
    every third row padded after 32-127 tokens, and a label the tokens
    carry, so that 20 steps from a random init can learn it: label-1
    rows draw their ids from the upper half of the vocabulary, label-0
    rows from the lower, and the first token (the one the classifier
    reads) is 101 + label."""
    import numpy as np

    from pyspark_tf_gke_tpu_torch.data.tfrecord import write_tfrecord_shards

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    half = BERT_VOCAB // 2
    ids = rng.integers(1000, half, (n, BERT_SEQ)) + labels[:, None] * (
        half - 1000)
    lengths = np.where(np.arange(n) % 3 == 0,
                       rng.integers(32, BERT_SEQ, n), BERT_SEQ)
    mask = (np.arange(BERT_SEQ)[None] < lengths[:, None]).astype(np.int64)
    ids = np.where(mask == 1, ids, 0)
    ids[:, 0] = 101 + labels
    write_tfrecord_shards({"input_ids": ids.astype(np.int64),
                           "attention_mask": mask,
                           "label": labels.astype(np.int64)},
                          str(root / "train"), num_shards=4)
    return str(root / "train-*.tfrecord")


def run_bert_training(torch, dev, counters=None):
    """Phase 7d: ``bert_finetune.main`` at BERT-base on the port's shards,
    classification 2 epochs x 10 steps then MLM 2 epochs x 5 steps: the
    losses finite, classification's falling from epoch 1 to 2, every
    training kernel launched. Then times and profiles two steady steps.
    Returns the launches of the classification run."""
    from pyspark_tf_gke_tpu_torch.train.bert_finetune import main as bert_main

    counters = counters or _train_counters()
    work = PORT_PKG / "_build" / "chip_smoke_bert"
    shutil.rmtree(work, ignore_errors=True)
    pattern = write_bert_shards(work / "shards")
    launches = {}
    for objective, epochs, steps in (("classification", 2, 10),
                                     ("mlm", 2, 5)):
        _reset(torch, counters)
        t0 = time.perf_counter()
        history = bert_main(["--data-pattern", pattern, *BERT_FLAGS,
                             "--objective", objective, "--epochs",
                             str(epochs), "--steps-per-epoch", str(steps),
                             "--output-dir", str(work / objective),
                             "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = _moved(counters)
        losses = history["loss"]
        log(f"  bert_finetune --objective {objective}, {epochs} epochs x "
            f"{steps} steps in {wall:.1f} s (init, data, training, "
            f"checkpoint; {CARD})")
        for key, vals in history.items():
            log(f"  {key}: {vals}")
        log(f"  kernel launches ({epochs * steps} steps): {moved}")
        check(all(math.isfinite(v) for v in losses),
              f"non-finite BERT {objective} loss {losses}")
        for name, n in moved.items():
            check(n > 0, f"kernel {name} was not launched on the BERT "
                  f"{objective} path")
        if objective == "classification":
            check(losses[1] < losses[0], f"BERT epoch-2 mean loss "
                  f"{losses[1]} is not below epoch 1's {losses[0]}")
            launches = moved
    shutil.rmtree(work, ignore_errors=True)
    profile_bert(torch, dev)
    return launches


def _bert_model(torch, dev, cfg, seed, use_kernels=True):
    from pyspark_tf_gke_tpu_torch.models.bert import (BertForPretraining,
                                                      init_params)

    with torch.device(dev):
        model = BertForPretraining(cfg, use_kernels=use_kernels,
                                   param_dtype=torch.float32)
    return model.load_params(init_params(cfg, seed=seed))


def _bert_batch(torch, dev, cfg, b, seed):
    """Ids with every other row padded after 80 tokens, labels, and MLM
    labels at half the real tokens (the loss a mean over ~1,700 of
    them at batch 32)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(1000, cfg.vocab_size, (b, BERT_SEQ), generator=g,
                        device=dev, dtype=torch.int32)
    mask = torch.ones(b, BERT_SEQ, dtype=torch.int32, device=dev)
    mask[::2, 80:] = 0
    pick = (torch.rand(b, BERT_SEQ, generator=g, device=dev) < 0.5) & (
        mask == 1)
    return {"input_ids": ids, "attention_mask": mask,
            "labels": torch.randint(0, 2, (b,), generator=g, device=dev),
            "mlm_labels": torch.where(pick, ids, -100)}


def _bert_loss(torch, model, batch):
    """The classification loss plus the MLM loss from one forward, so
    that every parameter takes a gradient."""
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS

    cls, mlm = TASKS["bert_classification"](), TASKS["bert_mlm"]()
    preds = cls.forward(model, batch)
    return (cls.loss_and_metrics(preds, batch)[0]
            + mlm.loss_and_metrics(preds, batch)[0])


def _bert_grads(torch, model, batch):
    loss = _bert_loss(torch, model, batch)
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def profile_bert(torch, dev):
    """Two steady BERT-base classification steps (bf16, 32 x 128) under
    ``torch.profiler``, after 5 timed without it."""
    from pyspark_tf_gke_tpu_torch.models.bert import BertConfig
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    cfg = BertConfig()
    trainer = Trainer(_bert_model(torch, dev, cfg, 0),
                      TASKS["bert_classification"](), tx=make_optimizer(1e-4))
    state = trainer.init_state()
    batch = _bert_batch(torch, dev, cfg, BERT_BATCH, 7)
    for _ in range(3):
        trainer.step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        trainer.step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 5
    log(f"  5 steady BERT-base steps without the profiler ({CARD}): "
        f"{step_ms:.2f} ms/step, {BERT_BATCH / step_ms * 1e3:.1f} "
        f"sequences/s, {BERT_BATCH * BERT_SEQ / step_ms * 1e3:.0f} tokens/s")
    wall, busy, top = _profiled(
        torch, lambda: [trainer.step(state, batch) for _ in range(2)])
    if busy <= 0:
        log(f"  2 steps: wall {wall:.2f} ms; device time not visible to "
            "torch.profiler")
        return
    log(f"  2 steps under the profiler: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%), idle "
        f"{100 * (1 - busy / wall):.1f}%")
    for name, ms in top[:12]:
        log(f"    {ms:9.3f} ms  {name[:90]}")


def check_bert_parity(torch, dev):
    """Phase 7e, phase 7's limits on BERT: a 2-layer f32 model at the
    full width trains 3 classification steps through the kernels and
    through ``use_kernels=False`` from one init (losses within 1e-4,
    step-0 gradients of the classification + MLM loss within 1e-4
    relative L2, whole tree and each tensor); then full-width bf16 step-0
    loss (within 1e-3) and gradients (5e-2 relative L2, each tensor 1e-1)
    through the kernels against the plain versions."""
    import dataclasses as dc

    from pyspark_tf_gke_tpu_torch.models.bert import BertConfig
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    cfg = BertConfig(num_layers=2, dtype=torch.float32)
    batches = [_bert_batch(torch, dev, cfg, 8, 40 + i) for i in range(3)]
    runs = {}
    for use_kernels in (True, False):
        model = _bert_model(torch, dev, cfg, 3, use_kernels)
        _, g0 = _bert_grads(torch, model, batches[0])
        trainer = Trainer(model, TASKS["bert_classification"](),
                          tx=make_optimizer(1e-4))
        state = trainer.init_state()
        losses = [float(trainer.step(state, b)[1]["loss"]) for b in batches]
        runs[use_kernels] = (g0, losses)
    rel, worst, worst_rel = _grad_diff(torch, runs[True][0], runs[False][0])
    dloss = max(abs(a - b) for a, b in zip(runs[True][1], runs[False][1]))
    log(f"  BERT f32 2-layer: losses kernels {runs[True][1]} vs plain "
        f"{runs[False][1]} (max diff {dloss:.2e}, tolerance 1e-4); step-0 "
        f"gradients relative L2 {rel:.2e}, worst tensor {worst} "
        f"{worst_rel:.2e} (tolerance 1e-4 each)")
    check(dloss <= 1e-4 and rel <= 1e-4 and worst_rel <= 1e-4,
          "BERT f32 training through the kernels disagrees with plain")

    cfg = dc.replace(cfg, num_layers=12, dtype=torch.bfloat16)
    batch = _bert_batch(torch, dev, cfg, BERT_BATCH, 50)
    loss_k, gk = _bert_grads(torch, _bert_model(torch, dev, cfg, 4), batch)
    loss_p, gp = _bert_grads(torch, _bert_model(torch, dev, cfg, 4, False),
                             batch)
    rel, worst, worst_rel = _grad_diff(torch, gk, gp)
    log(f"  BERT-base bf16 step-0: loss kernels {loss_k:.5f} vs plain "
        f"{loss_p:.5f} (diff {abs(loss_k - loss_p):.2e}, tolerance 1e-3); "
        f"gradients relative L2 {rel:.2e} (tolerance 5e-2); worst tensor "
        f"{worst} {worst_rel:.2e} (tolerance 1e-1)")
    check(all(bool(torch.isfinite(g).all()) for g in gk.values()),
          "non-finite BERT bf16 gradient")
    check(abs(loss_k - loss_p) <= 1e-3,
          "BERT bf16 loss through the kernels disagrees")
    check(rel <= 5e-2 and worst_rel <= 1e-1,
          "BERT bf16 gradients through the kernels disagree")


# -- phases 8 and 9: ResNet-50 training ---------------------------------------

RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS = 64, 224, (2, 10)


def resnet_batch(b: int, size: int, seed: int = 0):
    """Images ``default_rng(seed).uniform(0, 1)`` as f32 NHWC, labels in
    [0, 1000)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 1, size=(b, size, size, 3)
                                 ).astype(np.float32),
            "label": rng.integers(0, 1000, size=b).astype(np.int32)}


# launches of each ResNet kernel per training step of ResNet-50, by
# variant: K4 on the 36 1x1 convs, K5 on the 13 stride-1 3x3 convs of
# fused3 (none in fused, whose 3x3 convs are cuDNN's)
RESNET_K4 = ("fused_matmul_fwd", "fused_matmul_dx", "fused_matmul_dw")
RESNET_K5 = ("fused_conv3_fwd", "fused_conv3_dx", "fused_conv3_dw")
RESNET_PER_STEP = {
    "fused": {**{k: 36 for k in RESNET_K4}, **{k: 0 for k in RESNET_K5}},
    "fused3": {**{k: 36 for k in RESNET_K4}, **{k: 13 for k in RESNET_K5}},
}


def run_resnet_training(torch, dev, counters, variant):
    """ResNet-50 ``variant`` (bf16, f32 master weights and statistics)
    through ``Trainer.fit``: 2 epochs x 10 steps on one repeated batch of
    64 images at 224^2, Adam 1e-3; then one ``evaluate`` with
    ``train=False``, which must launch only the forward kernels (once per
    call site) and leave the statistics as they were."""
    import itertools

    from pyspark_tf_gke_tpu_torch.data.pipeline import put_batch
    from pyspark_tf_gke_tpu_torch.models.resnet import ResNet50
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    per_step = RESNET_PER_STEP[variant]
    t0 = time.perf_counter()
    model = ResNet50(norm_variant=variant, device=dev, seed=0)
    trainer = Trainer(model, TASKS["resnet"](), learning_rate=1e-3)
    state = trainer.init_state()
    init_stats = {k: v.clone() for k, v in state.batch_stats.items()}
    batch = resnet_batch(RESNET_BATCH, RESNET_IMAGE)
    log(f"  model ({sum(p.numel() for p in model.parameters())} parameters, "
        f"{len(init_stats)} statistics buffers) and batch ready in "
        f"{time.perf_counter() - t0:.1f} s")
    epochs, steps = RESNET_STEPS
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    state, history = trainer.fit(state, itertools.repeat(batch), epochs,
                                 steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    log(f"  Trainer.fit {epochs} epochs x {steps} steps in {wall:.1f} s")
    for key in ("loss", "accuracy", "step_time_ms", "examples_per_sec"):
        log(f"  {key}: {history[key]}")
    log(f"  kernel launches on the ResNet {variant} path ({epochs * steps} "
        f"steps): {launches}")
    losses = history["loss"]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(losses[1] < losses[0], f"epoch-2 mean loss {losses[1]} is not "
          f"below epoch 1's {losses[0]}")
    for name, n in launches.items():
        check(n == per_step[name] * epochs * steps, f"kernel {name} "
              f"launched {n} times, not {per_step[name]} per step")
    moved = [k for k, v in state.batch_stats.items()
             if not torch.equal(v, init_stats[k])]
    check(len(moved) == len(init_stats), f"{len(init_stats) - len(moved)} "
          "running statistics never left their init")
    # eval: the running statistics, the forward kernels without
    # statistics, no backward
    dev_batch = put_batch(batch, dev)
    before = {k: v.clone() for k, v in state.batch_stats.items()}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    metrics = trainer.evaluate(state, [dev_batch])
    torch.cuda.synchronize()
    eval_launches = {name: getattr(mod, attr)
                     for name, (mod, attr) in counters.items()}
    log(f"  evaluate (train=False): {metrics}; launches {eval_launches}")
    check(all(math.isfinite(v) for v in metrics.values()),
          f"non-finite eval metrics {metrics}")
    check(eval_launches == {k: n if k.endswith("_fwd") else 0
                            for k, n in per_step.items()},
          f"evaluate launched {eval_launches}")
    check(all(torch.equal(v, before[k])
              for k, v in state.batch_stats.items()),
          "evaluate changed the running statistics")
    return launches, trainer, state, dev_batch


def time_resnet(torch, trainer, state, batch, label, profile=True):
    """ms/step of ``trainer`` over 5 steady steps without the profiler;
    with ``profile``, two more steps under ``torch.profiler`` (device busy
    and idle share, top device ops)."""
    for _ in range(2):
        trainer.step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        trainer.step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    b = RESNET_BATCH
    log(f"  {label}: {ms:.2f} ms/step, {b / ms * 1e3:.1f} images/s (5 steady "
        "steps, no profiler)")
    if not profile:
        return ms
    wall, busy, top = _profiled(
        torch, lambda: [trainer.step(state, batch) for _ in range(2)])
    if busy <= 0:
        log(f"  2 steps: wall {wall:.2f} ms; device time not visible to "
            "torch.profiler")
        return ms
    log(f"  2 {label} steps under the profiler: wall {wall:.2f} ms, device "
        f"busy {busy:.2f} ms ({100 * busy / wall:.1f}%), idle "
        f"{100 * (1 - busy / wall):.1f}%")
    for name, t in top[:12]:
        log(f"    {t:9.3f} ms  {name[:90]}")
    return ms


def time_bn_resnet(torch, dev, batch):
    """The ``bn`` variant's step (cuDNN convs, no port kernel), the
    yardstick of the fused paths."""
    from pyspark_tf_gke_tpu_torch.models.resnet import ResNet50
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    trainer = Trainer(ResNet50(norm_variant="bn", device=dev, seed=0),
                      TASKS["resnet"](), learning_rate=1e-3)
    ms = time_resnet(torch, trainer, trainer.init_state(), batch,
                     "bn (cuDNN convs, no port kernel)", profile=False)
    del trainer
    torch.cuda.empty_cache()
    return ms


def _nonzero_norm3(torch, model, seed: int):
    """Every norm3 scale to seeded values in [0.1, 0.2): at its zero
    init every residual branch's gradient (K4dx and K4dw inside the
    branches, and the statistics' cotangents) is exactly zero. Larger
    scales make the f32 gradients of this deep, small-batch network
    chaotic: at [0.25, 0.75) a 1e-6 relative change of the input moves
    them by 1e-2 (relative L2) on the CPU; at [0.1, 0.2), by 5e-4."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm3_scale"):
                p.copy_(torch.rand(p.shape, generator=g) * 0.1 + 0.1)


def _resnet_grads(torch, model, batch):
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS

    task = TASKS["resnet"]()
    loss, _ = task.loss_and_metrics(task.forward(model, batch, train=True),
                                    batch)
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


# Kernels against use_kernels=False (the plain versions, which round at
# the kernels' points) on one ResNet-50 training step: |loss diff|,
# whole-tree and worst-tensor gradient relative L2, and the running
# statistics' max abs difference (f32). Every K4 / K5 call agrees with
# its plain version on the same inputs to ~1e-6 (f32) — held below as
# CALL_REL_L2 — but the network amplifies rounding-level changes into
# the gradients: on an H100 the plain versions on the card against the
# same plain versions on the host's CPU read 1.0e-2 (f32, fused), as far
# apart as the kernels are, and the "noise" reading printed beside (the
# plain versions against themselves with the input scaled by 1 + 1e-6)
# reads 1.7e-3 (f32) and 1.0e-1 (bf16; worst tensor bn_init.bias 0.42,
# whose gradient is zero up to rounding). Limits: the H100 readings
# (PERF.md, ResNet-50 parity) with a margin of 2-10x; fused3's f32 loss
# read 0 and takes 10x fused's 4.8e-7.
RESNET_PARITY_LIMITS = {
    ("fused", "float32"): dict(loss=1e-5, rel=3e-2, worst=5e-2, stats=1e-5),
    ("fused", "bfloat16"): dict(loss=2e-3, rel=2e-1, worst=6e-1, stats=None),
    ("fused3", "float32"): dict(loss=5e-6, rel=3e-2, worst=5e-2, stats=3e-6),
    ("fused3", "bfloat16"): dict(loss=1e-3, rel=2e-1, worst=7.5e-1,
                                 stats=None),
}
# each K4 and K5 call of the kernels' step against its plain version on
# the same inputs, relative L2 of every output: f32 sums in another order
# (K4 read <= 1.2e-6); bf16 outputs one rounding apart where the f32
# sums straddle a rounding point (K4 read <= 8.9e-5)
CALL_REL_L2 = {"float32": 1e-5, "bfloat16": 1e-3}


class _CallCheck:
    """While active, every K4 and K5 wrapper call also runs the plain
    version on the same inputs and keeps the worst relative L2 per
    output; ``calls`` counts the kernel calls by op."""

    def __init__(self, torch):
        from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc
        from pyspark_tf_gke_tpu_torch.ops import fused_matmul as fm

        self.torch, self.worst = torch, {}
        self.calls = {"K4": 0, "K5": 0}
        # (op, module, wrapper names, plain versions)
        self.ops = (
            ("K4", fm, ("norm_relu_matmul_fwd", "norm_relu_matmul_dx",
                        "norm_relu_matmul_dw"),
             (fm._fwd_plain, fm.norm_relu_matmul_dx_plain,
              fm.norm_relu_matmul_dw_plain)),
            ("K5", fc, ("conv3_fwd", "conv3_dx", "conv3_dw"),
             (fc.conv3_fwd_plain, fc.conv3_dx_plain, fc.conv3_dw_plain)))
        self.saved = [(mod, names, [getattr(mod, n) for n in names])
                      for _, mod, names, _ in self.ops]

    def _note(self, what, got, want):
        if got is None:
            return
        got, want = got.float(), want.float()
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        if rel >= self.worst.get(what, (-1.0,))[0]:
            self.worst[what] = (rel, tuple(got.shape))

    def _wrap(self, op, kernels, plains):
        fwd, dx, dw = kernels
        pfwd, pdx, pdw = plains

        def check_fwd(x, w, a, b, relu, want_stats):
            y, st = fwd(x, w, a, b, relu, want_stats)
            ry, rst = pfwd(x, w, a, b, relu, want_stats)
            self._note(f"{op}f y", y, ry)
            self._note(f"{op}f stats", st, rst)
            self.calls[op] += 1
            return y, st

        def check_dx(dy, w, x, a, b, relu):
            got, ds = dx(dy, w, x, a, b, relu)
            want, rds = pdx(dy, w, x, a, b, relu)
            self._note(f"{op}dx dx", got, want)
            self._note(f"{op}dx da/db", ds, rds)
            self.calls[op] += 1
            return got, ds

        def check_dw(x, dy, a, b, relu):
            got = dw(x, dy, a, b, relu)
            self._note(f"{op}dw dw", got, pdw(x, dy, a, b, relu))
            self.calls[op] += 1
            return got

        return check_fwd, check_dx, check_dw

    def __enter__(self):
        for (op, mod, names, plains), (_, _, kernels) in zip(self.ops,
                                                             self.saved):
            for name, fn in zip(names, self._wrap(op, kernels, plains)):
                setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, names, kernels in self.saved:
            for name, fn in zip(names, kernels):
                setattr(mod, name, fn)


def check_resnet_parity(torch, dev, variant):
    """One training forward and backward of ResNet-50 ``variant`` through
    the kernels against ``use_kernels=False`` from one init with every
    norm3 scale non-zero: f32 (TF32 off) at full depth on 8 images of
    64^2 — step-0 loss, gradients and the running statistics after the
    step; bf16 on the full path (64 images of 224^2) — step-0 loss and
    gradients. During the kernels' step every K4 and K5 call is held
    against its plain version on the same inputs."""
    from pyspark_tf_gke_tpu_torch.data.pipeline import put_batch
    from pyspark_tf_gke_tpu_torch.models.resnet import ResNet50

    per_step = RESNET_PER_STEP[variant]
    want_calls = {"K4": 3 * per_step[RESNET_K4[0]],
                  "K5": 3 * per_step[RESNET_K5[0]]}
    results = {}
    for dtype, b, size in ((torch.float32, 8, 64),
                           (torch.bfloat16, RESNET_BATCH, RESNET_IMAGE)):
        name = str(dtype).split(".")[-1]
        batch = put_batch(resnet_batch(b, size, seed=1), dev)
        nudged = dict(batch, image=batch["image"] * (1.0 + 1e-6))
        runs = {}
        for key, use_kernels, inputs in (("kernels", True, batch),
                                         ("plain", False, batch),
                                         ("noise", False, nudged)):
            model = ResNet50(norm_variant=variant, dtype=dtype, device=dev,
                             seed=3, use_kernels=use_kernels)
            _nonzero_norm3(torch, model, 4)
            if use_kernels:
                with _CallCheck(torch) as calls:
                    loss, grads = _resnet_grads(torch, model, inputs)
            else:
                loss, grads = _resnet_grads(torch, model, inputs)
            stats = {k: v.clone() for k, v in model.named_buffers()}
            runs[key] = (loss, grads, stats)
            del model
        worst_call = max(rel for rel, _ in calls.worst.values())
        log(f"  {variant} {name} B={b} {size}^2: {calls.calls} kernel calls "
            "each held against its plain version on the same inputs, worst "
            "relative L2 per output: " + ", ".join(
                f"{what} {rel:.2e} {list(shape)}"
                for what, (rel, shape) in calls.worst.items())
            + f" (limit {CALL_REL_L2[name]:g})")
        check(calls.calls == want_calls and worst_call <= CALL_REL_L2[name],
              f"{variant} {name}: a kernel call of the training step "
              "disagrees with its plain version")
        (lk, gk, sk), (lp, gp, sp) = runs["kernels"], runs["plain"]
        rel, worst, worst_rel = _grad_diff(torch, gk, gp)
        nrel, nworst, nworst_rel = _grad_diff(torch, runs["noise"][1], gp)
        check(all(bool(torch.isfinite(g).all()) for g in gk.values()),
              f"non-finite {variant} {name} gradient")
        stat_err = max(float((sk[k] - sp[k]).abs().max()) for k in sk)
        lim = RESNET_PARITY_LIMITS[variant, name]
        log(f"  {variant} {name} B={b} {size}^2: loss kernels {lk:.6f} vs "
            f"plain {lp:.6f} (diff {abs(lk - lp):.2e}, limit "
            f"{lim['loss']:g}); gradients relative L2 {rel:.2e} (limit "
            f"{lim['rel']:g}), worst tensor {worst} {worst_rel:.2e} (limit "
            f"{lim['worst']:g}); running statistics max abs diff "
            f"{stat_err:.2e} (limit {lim['stats']})")
        log(f"    noise: plain with the input x (1 + 1e-6) vs plain: "
            f"gradients relative L2 {nrel:.2e}, worst tensor {nworst} "
            f"{nworst_rel:.2e}")
        check(abs(lk - lp) <= lim["loss"] and rel <= lim["rel"]
              and worst_rel <= lim["worst"]
              and (lim["stats"] is None or stat_err <= lim["stats"]),
              f"{variant} {name} ResNet-50 training through the kernels "
              "disagrees with the plain versions")
        results[name] = (abs(lk - lp), rel, worst_rel, stat_err)
        torch.cuda.empty_cache()
    return results


# -- phase 12: the other ResNet variants -------------------------------------

# (norm_variant, s2d_stem): every variant of models/resnet.py not trained
# above, and the space-to-depth stem under both stem families
RESNET_OTHER_VARIANTS = (("bn_f32", False), ("gn", False), ("none", False),
                         ("nf", False), ("nf", True), ("fused3", True))


def check_resnet_variants(torch, dev, k5_counters):
    """One ``Trainer`` step of ResNet-50 (bf16) for each of
    :data:`RESNET_OTHER_VARIANTS` on 8 images of 64^2: the forward and
    backward give a finite loss and finite gradients, the update finite
    parameters, and ``fused3`` with the s2d stem launches the K5
    kernels."""
    from pyspark_tf_gke_tpu_torch.data.pipeline import put_batch
    from pyspark_tf_gke_tpu_torch.models.resnet import ResNet50
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    batch = put_batch(resnet_batch(8, 64, seed=2), dev)
    for variant, s2d in RESNET_OTHER_VARIANTS:
        tag = f"{variant}{' + s2d_stem' if s2d else ''}"
        model = ResNet50(norm_variant=variant, s2d_stem=s2d, device=dev,
                         seed=5)
        for mod, attr in k5_counters.values():
            setattr(mod, attr, 0)
        loss, grads = _resnet_grads(torch, model, batch)
        torch.cuda.synchronize()
        launches = {name: getattr(mod, attr)
                    for name, (mod, attr) in k5_counters.items()}
        trainer = Trainer(model, TASKS["resnet"](), learning_rate=1e-3)
        state, metrics = trainer.step(trainer.init_state(), batch)
        step_loss = float(metrics["loss"])
        finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
        params_ok = all(bool(torch.isfinite(p).all())
                        for p in state.params.values())
        gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
        log(f"  {tag}: loss {loss:.5f}, {len(grads)} gradients, all finite "
            f"{finite}, norm {gnorm:.4e}; after one Adam step: loss "
            f"{step_loss:.5f}, parameters finite {params_ok}; K5 launches "
            f"{launches}")
        check(math.isfinite(loss) and math.isfinite(step_loss) and finite
              and params_ok and gnorm > 0, f"ResNet-50 {tag}: non-finite "
              "or zero training step")
        if variant == "fused3":
            check(all(n > 0 for n in launches.values()),
                  f"ResNet-50 {tag} did not launch every K5 kernel")
        del model, trainer, state
        torch.cuda.empty_cache()


# -- phase 13: the reference-parity training plane (P9) ----------------------

PARITY_REPORT = ROOT / "tools" / "parity_report.json"
# the CLI runs at the reference's size: about 320 PNGs at 256x320, the
# B1 head, bf16, batch 32, 2 epochs (8 steps each); a save every epoch,
# a fault in epoch 2
P9_IMAGES, P9_SIZE, P9_BATCH, P9_EPOCHS = 320, (256, 320), 32, 2
P9_CSV_STEPS = 96


def make_spot_arrays(n: int, height: int, width: int, seed: int = 1337):
    """``tools/loss_parity.py::make_spot_arrays``: ``n`` dark frames with
    a bright gaussian spot, [0, 1] f32 NHWC, and the spot's centre in
    pixels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    images = np.empty((n, height, width, 3), np.float32)
    targets = np.empty((n, 2), np.float32)
    for i in range(n):
        cx = float(rng.uniform(4, width - 4))
        cy = float(rng.uniform(4, height - 4))
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 3.0 ** 2)))
        img = (blob[..., None] * np.array([255.0, 40.0, 40.0]) +
               rng.normal(8, 4, (height, width, 3))).clip(0, 255)
        images[i] = img / 255.0
        targets[i] = (cx, cy)
    return images, targets


def make_health_arrays(n: int, num_classes: int = 6, seed: int = 1337):
    """``tools/loss_parity.py::make_health_arrays``: 3 features (value,
    lower_ci, upper_ci) clustered by label."""
    import numpy as np

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    centers = rng.uniform(-3, 3, (num_classes, 3)).astype(np.float32)
    feats = centers[labels] + rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    feats[:, 1] = feats[:, 0] - np.abs(feats[:, 1]) * 0.1
    feats[:, 2] = feats[:, 0] + np.abs(feats[:, 2]) * 0.1
    return feats.astype(np.float32), labels


def _all_counters():
    """Every port kernel's launch counter."""
    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc
    from pyspark_tf_gke_tpu_torch.ops import fused_matmul as fm
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln

    return {**_serve_counters(), **_train_counters(), **_block_counters(),
            "layernorm_bwd": (ln, "bwd_launches"),
            "fused_matmul_fwd": (fm, "fwd_launches"),
            "fused_matmul_dx": (fm, "dx_launches"),
            "fused_matmul_dw": (fm, "dw_launches"),
            "fused_conv3_fwd": (fc, "fwd_launches"),
            "fused_conv3_dx": (fc, "dx_launches"),
            "fused_conv3_dw": (fc, "dw_launches")}


def _epoch_history(torch, trainer, arrays, batch_size, epochs, keys):
    """``tools/loss_parity.py``'s loop: ``epochs`` unshuffled passes in
    order over ``arrays`` (staged on the card once), one ``Trainer.step``
    a batch, each key's per-epoch mean."""
    from pyspark_tf_gke_tpu_torch.data.pipeline import put_batch

    n = len(next(iter(arrays.values())))
    steps = n // batch_size
    batches = [put_batch({k: v[i * batch_size:(i + 1) * batch_size]
                          for k, v in arrays.items()}, trainer.device)
               for i in range(steps)]
    state = trainer.init_state()
    history = {k: [] for k in keys}
    for _ in range(epochs):
        sums = None
        for batch in batches:
            state, metrics = trainer.step(state, batch)
            sums = ({k: metrics[k] for k in keys} if sums is None else
                    {k: sums[k] + metrics[k] for k in keys})
        for k in keys:
            history[k].append(float(sums[k]) / steps)
    return history


def check_loss_parity(torch, dev):
    """Phase 13 (a): CNN-B1 (f32) and the MLP trained as
    ``tools/loss_parity.py`` trains the JAX side (Adam lr 1e-3, eps 1e-7;
    in order, no shuffle; the report's sizes) from the same initial
    parameters (the models' init at seed 1337: the JAX run's), held
    to its ``compare`` / ``compare_cls`` gates against the TF runs in
    ``tools/parity_report.json`` (read as data), and the first epochs to
    the recorded JAX history (1% relative)."""
    from pyspark_tf_gke_tpu_torch.models.cnn import CNNRegressor
    from pyspark_tf_gke_tpu_torch.models.mlp import MLPClassifier
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    report = json.loads(PARITY_REPORT.read_text())
    out = {}
    for name, section in (("cnn_b1", report["cnn_b1"]),
                          ("mlp_csv", report["mlp_csv"])):
        cfg, opt = section["config"], section["optimizer"]
        t0 = time.perf_counter()
        if name == "cnn_b1":
            images, targets = make_spot_arrays(cfg["images"], cfg["height"],
                                               cfg["width"], seed=1337)
            arrays = {"image": images, "target": targets}
            model = CNNRegressor(flat=True, dtype=None, device=dev,
                                 image_size=(cfg["height"], cfg["width"]),
                                 seed=1337)
            task, metric = TASKS["regression"](), "mae"
        else:
            feats, labels = make_health_arrays(cfg["rows"])
            arrays = {"x": feats, "y": labels}
            model = MLPClassifier(int(labels.max()) + 1, feats.shape[1],
                                  device=dev, seed=1337)
            task, metric = TASKS["classification"](), "accuracy"
        init_s = time.perf_counter() - t0
        trainer = Trainer(model, task, tx=make_optimizer(opt["lr"],
                                                         eps=opt["eps"]))
        t0 = time.perf_counter()
        hist = _epoch_history(torch, trainer, arrays, cfg["batch_size"],
                              cfg["epochs"], ("loss", metric))
        wall = time.perf_counter() - t0
        checks = section["checks"]
        loss_gate = checks["final_loss_not_worse_than_tf_best"]
        metric_gate = checks[f"final_{metric}_not_worse_than_tf_best"]
        final_loss, final_metric = hist["loss"][-1], hist[metric][-1]
        jax_loss = section["jax_history"]["loss"]
        log(f"  {name}: {cfg}, Adam lr {opt['lr']} eps {opt['eps']}, f32 "
            f"from the JAX run's init ({init_s:.1f} s), {wall:.1f} s on "
            f"{CARD}")
        log(f"    loss by epoch: {[round(v, 4) for v in hist['loss']]}")
        log(f"    JAX's recorded: {[round(v, 4) for v in jax_loss]}")
        log(f"    {metric} by epoch: {[round(v, 4) for v in hist[metric]]}")
        log(f"    final loss: port {final_loss:.6g}, TF best "
            f"{loss_gate['tf_best']:.6g} (TF final {loss_gate['tf_final']:.6g}"
            f"), JAX final {loss_gate['jax_final']:.6g}; gate <= TF best x "
            f"{loss_gate['tol']}")
        log(f"    final {metric}: port {final_metric:.6g}, TF best "
            f"{metric_gate['tf_best']:.6g} (TF final "
            f"{metric_gate['tf_final']:.6g}), JAX final "
            f"{metric_gate['jax_final']:.6g}")
        check(all(math.isfinite(v) for v in hist["loss"] + hist[metric]),
              f"{name}: non-finite history {hist}")
        early = [abs(a - b) / abs(b) for a, b in zip(hist["loss"][:3],
                                                     jax_loss[:3])]
        check(max(early) < 1e-2, f"{name}: the first epochs' losses "
              f"{hist['loss'][:3]} are not within 1% of JAX's {jax_loss[:3]}")
        check(hist["loss"][-1] < hist["loss"][0],
              f"{name}: the loss did not fall ({hist['loss']})")
        check(final_loss <= loss_gate["tf_best"] * loss_gate["tol"],
              f"{name}: final loss {final_loss} above TF best "
              f"{loss_gate['tf_best']} x {loss_gate['tol']}")
        if metric == "mae":
            limit = metric_gate["tf_best"] * (1.0 + metric_gate["tol"])
            check(final_metric <= limit, f"{name}: final MAE {final_metric} "
                  f"above TF best x (1 + {metric_gate['tol']}) = {limit}")
        else:
            limit = metric_gate["tf_best"] - metric_gate["tol"]
            check(final_metric >= limit, f"{name}: final accuracy "
                  f"{final_metric} below TF best - {metric_gate['tol']} = "
                  f"{limit}")
        out[name] = {"loss": final_loss, metric: final_metric, "s": wall,
                     "first_epochs_rel": max(early)}
        del model, trainer
        torch.cuda.empty_cache()
    return out


def _fit_starts(events):
    return [e["start_step"] for e in events if e["kind"] == "train_fit_start"]


def _p9_cli(trail: Path, args):
    """``train.cli.main(args)`` with its event trail in the file
    ``trail``; returns the history and the trail's events."""
    from pyspark_tf_gke_tpu_torch.obs.events import (EventLog, read_events,
                                                     set_event_log)
    from pyspark_tf_gke_tpu_torch.train import cli

    set_event_log(EventLog(str(trail)))
    try:
        history = cli.main(args)
    finally:
        set_event_log(None)
    return history, list(read_events(str(trail)))


def _check_cli_run(tag, out: Path, history, events, notes, every):
    """The gates of one faulted CLI run (epochs of ``every`` steps, a save
    at each epoch's end, a fault in epoch 2): it restarted once, at the
    save of step ``every``, and ran its epochs from there; every
    artifact written; every loss finite."""
    starts = _fit_starts(events)
    kinds = [e["kind"] for e in events]
    saved = every
    final = saved + P9_EPOCHS * every
    text = (out / notes).read_text()
    log(f"  {tag}: fit started at steps {starts}; events "
        f"{sorted(set(kinds))}; loss {history['loss']}; "
        f"{[line for line in text.splitlines() if 'step' in line]}")
    check(starts == [0, saved], f"{tag}: the restart did not resume at the "
          f"saved step {saved} (fit started at {starts})")
    check(kinds.count("fault_injected") == 1
          and "recovery_succeeded" in kinds,
          f"{tag}: expected one injected fault and a recovery, got {kinds}")
    check(f"final step: {final}" in text, f"{tag}: the run notes do not "
          f"end at step {final}:\n{text}")
    check((out / "history.json").is_file()
          and json.loads((out / "history.json").read_text()) == history,
          f"{tag}: history.json missing or not the run's")
    check(len(history["loss"]) == P9_EPOCHS
          and all(math.isfinite(v) for v in history["loss"]
                  + history.get("val_loss", [])),
          f"{tag}: non-finite or missing losses {history}")
    check((out / "checkpoints" / str(final) / "state.pt").is_file(),
          f"{tag}: no checkpoint at step {final}")


def run_p9_cli(torch, dev):
    """Phase 13 (b): ``train.cli`` end to end in image mode (B1, bf16,
    about 320 PNGs at 256x320) and CSV mode (the 18,154-row reference
    CSV, epochs of 96 steps), each with a save every epoch, a fault in
    epoch 2 and one restart; then the image checker on the image run's
    checkpoint."""
    import numpy as np

    from pyspark_tf_gke_tpu_torch.data.csv_loader import load_csv
    from pyspark_tf_gke_tpu_torch.data.pipeline import train_validation_split
    from pyspark_tf_gke_tpu_torch.data.synthetic import (
        make_reference_csv, make_synthetic_image_dataset)
    from pyspark_tf_gke_tpu_torch.evaluate.image_checker import (
        ManualImageChecker)

    work = PORT_PKG / "_build" / "chip_smoke_p9"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    imgs = make_synthetic_image_dataset(str(work / "imgs"),
                                        num_images=P9_IMAGES,
                                        height=P9_SIZE[0], width=P9_SIZE[1])
    csv = make_reference_csv(str(work / "health.csv"))
    log(f"  {P9_IMAGES} PNGs at {P9_SIZE[0]}x{P9_SIZE[1]} and the "
        f"reference CSV written in {time.perf_counter() - t0:.1f} s")
    common = ["--epochs", str(P9_EPOCHS), "--batch-size", str(P9_BATCH),
              "--checkpoint-every-steps", "1", "--max-restarts", "1",
              "--heartbeat-every-steps", "1", "--device", dev.type]
    # image mode: 256 training images, 8 steps an epoch
    every = (P9_IMAGES - int(P9_IMAGES * 0.2)) // P9_BATCH
    out = work / "image_run"
    t0 = time.perf_counter()
    history, events = _p9_cli(work / "image_events.jsonl", [
        "--data-path", imgs, "--flat-layer", "--img-height",
        str(P9_SIZE[0]), "--img-width", str(P9_SIZE[1]), "--output-dir",
        str(out), "--fail-at-steps", str(every + every // 2)] + common)
    image_s = time.perf_counter() - t0
    log(f"  image mode (B1, bf16): {image_s:.1f} s, step_time_ms "
        f"{history['step_time_ms']}, examples_per_sec "
        f"{history['examples_per_sec']}, mae {history['mae']}, val_mae "
        f"{history.get('val_mae')}")
    _check_cli_run("image mode", out, history, events, "cnn-b1.txt", every)
    # CSV mode: 96-step epochs over the rows load_csv keeps (a quarter
    # of a pass at batch 32), so the restore lands inside a data epoch
    n_rows = len(load_csv(csv)[1])
    per_pass = len(train_validation_split(n_rows, 0.2)[0]) // P9_BATCH
    every_csv = P9_CSV_STEPS
    out_csv = work / "csv_run"
    t0 = time.perf_counter()
    history_csv, events_csv = _p9_cli(work / "csv_events.jsonl", [
        "--data-path", csv, "--output-dir", str(out_csv),
        "--steps-per-epoch", str(every_csv), "--fail-at-steps",
        str(every_csv + every_csv // 2)] + common)
    csv_s = time.perf_counter() - t0
    log(f"  CSV mode (MLP, {n_rows} rows kept, {per_pass} batches a pass, "
        f"{every_csv} steps an epoch): {csv_s:.1f} s, step_time_ms "
        f"{history_csv['step_time_ms']}, accuracy {history_csv['accuracy']}"
        f", val_accuracy {history_csv.get('val_accuracy')}")
    _check_cli_run("CSV mode", out_csv, history_csv, events_csv, "mlp.txt",
                   every_csv)
    labels = json.loads((out_csv / "label_map.json").read_text())
    check(len(labels) == 15 and "" not in labels.values(),
          f"label_map.json holds {labels}")
    # the checker on the image run's last checkpoint, every image
    t0 = time.perf_counter()
    checker = ManualImageChecker(str(out / "checkpoints"), P9_SIZE,
                                 flat=True, device=dev)
    result = checker.main(imgs, plots=False)
    log(f"  ManualImageChecker (f32) over {result['n_images']} images in "
        f"{time.perf_counter() - t0:.1f} s: mean pixel error "
        f"{result['mean_px_error']:.3f}, max {result['max_px_error']:.3f}")
    check(result["n_images"] == P9_IMAGES
          and np.isfinite([result["mean_px_error"],
                           result["max_px_error"]]).all(),
          f"image checker: {result}")
    del checker
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"image_s": image_s, "csv_s": csv_s, **result}


def time_p9_steps(torch, dev):
    """Phase 13 (c): a CNN-B1 step at batch 32 x 256x320 in f32 and bf16
    (5 steady steps, then two under ``torch.profiler``: host wall against
    device busy, top device ops), and an MLP step at batch 32."""
    from pyspark_tf_gke_tpu_torch.data.pipeline import put_batch
    from pyspark_tf_gke_tpu_torch.models.cnn import CNNRegressor
    from pyspark_tf_gke_tpu_torch.models.mlp import MLPClassifier
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    images, targets = make_spot_arrays(P9_BATCH, *P9_SIZE, seed=3)
    batch = put_batch({"image": images, "target": targets}, dev)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = f"CNN-B1 {str(dtype).split('.')[-1]}"
        trainer = Trainer(CNNRegressor(flat=True, dtype=dtype, device=dev,
                                       image_size=P9_SIZE),
                          TASKS["regression"](), learning_rate=1e-3)
        state = trainer.init_state()
        for _ in range(2):
            trainer.step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            trainer.step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 5
        log(f"  {tag}, batch {P9_BATCH} x {P9_SIZE[0]}x{P9_SIZE[1]}: "
            f"{ms:.2f} ms/step, {P9_BATCH / ms * 1e3:.1f} images/s (5 "
            f"steady steps, no profiler; {CARD})")
        wall, busy, top = _profiled(
            torch, lambda: [trainer.step(state, batch) for _ in range(2)])
        check(busy > 0, f"{tag}: torch.profiler saw no device time")
        log(f"  2 {tag} steps under the profiler: wall {wall:.2f} ms, "
            f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%), idle "
            f"{100 * (1 - busy / wall):.1f}%")
        for name, t in top[:10]:
            log(f"    {t:9.3f} ms  {name[:90]}")
        out[tag] = ms
        del trainer, state
        torch.cuda.empty_cache()
    feats, labels = make_health_arrays(P9_BATCH)
    trainer = Trainer(MLPClassifier(6, 3, device=dev),
                      TASKS["classification"](), learning_rate=1e-3)
    state = trainer.init_state()
    mlp_batch = put_batch({"x": feats, "y": labels}, dev)
    for _ in range(5):
        trainer.step(state, mlp_batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        trainer.step(state, mlp_batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 50
    wall, busy, _ = _profiled(torch, lambda: [trainer.step(state, mlp_batch)
                                              for _ in range(5)])
    log(f"  MLP, batch {P9_BATCH}: {ms:.3f} ms/step (50 steady steps); 5 "
        f"steps under the profiler: wall {wall:.2f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}%)")
    out["MLP"] = ms
    return out


def run_p9(torch, dev):
    """Phase 13, with every kernel counter at 0 before it and read after:
    the P9 path runs cuDNN convs, cuBLAS products and PyTorch's
    elementwise ops, no port kernel."""
    counters = _all_counters()
    _reset(torch, counters)
    t0 = time.perf_counter()
    parity = check_loss_parity(torch, dev)
    cli = run_p9_cli(torch, dev)
    steps = time_p9_steps(torch, dev)
    torch.cuda.synchronize()
    launches = _moved(counters)
    log(f"  port kernel launches on the P9 path: {launches}")
    check(not any(launches.values()),
          f"the P9 path launched port kernels: {launches}")
    log(f"  phase 13 took {time.perf_counter() - t0:.1f} s: {parity}, "
        f"{cli}, {steps}")
    return launches


# -- phase 14: ViT-Base, the MoE FFN, the native ETL chain, the faults (P10) --

# ViT-Base/16 at the JAX bench's shape (bench.py:244-258, Dosovitskiy et
# al. 2021): batch 64 of 224^2, 1000 classes, bf16, Adam lr 1e-3
VIT_BATCH, VIT_IMAGE, VIT_CLASSES = 64, 224, 1000
VIT_STEPS = (2, 10)  # warm-up, timed
VIT_SEQ = (VIT_IMAGE // 16) ** 2 + 1  # 196 patches + CLS = 197
# per ViT-Base training step (forward + backward, 12 layers): K2f, K2dq
# and K2dkv once a layer; K3 and K3b at ln_embed, twice a layer and at
# ln_final (2 + 2 x 12 = 26)
VIT_PER_STEP = {"flash_attention_fwd": 12, "flash_attention_dq": 12,
                "flash_attention_dkv": 12, "layernorm": 26,
                "layernorm_bwd": 26}
MOE_FLAGS = ["--num-experts", "8", "--moe-every", "2"]
MOE_BERT_STEPS = 10


def _flash_s197_record(torch, fa, name, q, k, v, dout, mask, errs):
    """K2f, K2dq and K2dkv at ViT-Base's training shape (non-causal, an
    all-ones key mask), eager and graph-replayed, beside their plain
    versions, SDPA's forward and backward and the bounds: q/k/v (dO,
    lse, delta) read and out (dq; dk, dv) written once; 4, 6 and 8
    products of D per (query, key) pair."""
    import torch.nn.functional as F

    b, s, h, d = q.shape
    shape = f"B={b} S={s} H={h} D={d} non-causal {name}"
    out, lse = fa.flash_attention_fwd(q, k, v, mask, False)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    fwd = lambda: fa.flash_attention_fwd(q, k, v, mask, False)  # noqa: E731
    dq = lambda: fa.flash_attention_dq(  # noqa: E731
        dout, q, k, v, lse, delta, mask, False)
    dkv = lambda: fa.flash_attention_dkv(  # noqa: E731
        dout, q, k, v, lse, delta, mask, False)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    lib_bwd, lib_bwd_graph, _, _ = _sdpa_bwd_times(torch, F, q, k, v, dout,
                                                   causal=False)
    plain_fwd = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, mask,
                                                         False))
    plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, dout, lse, delta, mask, False))
    pairs = b * h * s * s
    row = q.numel() * q.element_size()
    vecs = b * h * s * 4
    recs = {}
    for key, fn, nbytes, ops, plain, lib, lib_graph, err in (
            ("flash_attention_fwd", fwd, 4 * row + vecs, 4 * d * pairs,
             plain_fwd, cuda_ms(sdpa), graph_ms(sdpa), errs[0]),
            ("flash_attention_dq", dq, 5 * row + 2 * vecs, 6 * d * pairs,
             plain_bwd, lib_bwd, lib_bwd_graph, errs[1]),
            ("flash_attention_dkv", dkv, 6 * row + 2 * vecs, 8 * d * pairs,
             plain_bwd, lib_bwd, lib_bwd_graph, errs[2])):
        bms, by = bound(nbytes, ops, name)
        recs[key] = dict(max_abs_err=err, ms=cuda_ms(fn),
                         graph_ms=graph_ms(fn), plain_ms=plain,
                         library_ms=lib, library_graph_ms=lib_graph,
                         bound_ms=bms, bound_by=by, shape=shape)
        r = recs[key]
        log(f"  {key} {shape}: kernel {r['ms']:.4f} ms, graph-replayed "
            f"{r['graph_ms']:.4f}, plain {plain:.4f}, SDPA "
            f"{'forward' if key.endswith('fwd') else 'backward'} "
            f"{lib:.4f} (graph-replayed {lib_graph}), bound {bms:.4f} "
            f"({by}); {CARD}")
    return recs


def check_flash_s197(torch, dev):
    """K2f, K2dq and K2dkv at ViT-Base's S = 197 (no tile divides it)
    against their plain versions, non-causal over an all-ones key mask
    as the ViT calls them, in bf16 (the tensor-core kernels) and f32,
    forward and backward; then timed at the training shape B=64 S=197
    H=12 D=64 in bf16. Returns the records by kernel."""
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(14)
    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b in (8, VIT_BATCH):
            if dtype == torch.float32 and b == VIT_BATCH:
                continue
            q, k, v, dout = (torch.randn(b, VIT_SEQ, 12, 64, generator=g,
                                         device=dev).to(dtype)
                             for _ in range(4))
            mask = torch.ones(b, VIT_SEQ, dtype=torch.bool, device=dev)
            tag = f"{name} B={b} S={VIT_SEQ} H=12 D=64 non-causal"
            out, lse = fa.flash_attention_fwd(q, k, v, mask, False)
            ref, ref_lse = fa.flash_attention_plain(q, k, v, mask, False)
            err_f = compare(out, ref, name, f"flash fwd {tag} out")
            compare(lse, ref_lse, "float32", f"flash fwd {tag} lse")
            delta = (dout.float() * out.float()).sum(-1).transpose(
                1, 2).contiguous()
            dq = fa.flash_attention_dq(dout, q, k, v, lse, delta, mask,
                                       False)
            dk, dv = fa.flash_attention_dkv(dout, q, k, v, lse, delta, mask,
                                            False)
            want = fa.flash_attention_bwd_plain(q, k, v, dout, lse, delta,
                                                mask, False)
            errs = [compare(got, ref_g, name, f"flash bwd {tag} {what}")
                    for got, ref_g, what in zip((dq, dk, dv), want,
                                                ("dq", "dk", "dv"))]
            if dtype == torch.bfloat16 and b == VIT_BATCH:
                recs = _flash_s197_record(
                    torch, fa, name, q, k, v, dout, mask,
                    (err_f, errs[0], max(errs[1], errs[2])))
    return recs


def _vit_model(torch, dev, cfg, num_classes, seed, use_kernels=True):
    from pyspark_tf_gke_tpu_torch.models.vit import ViTClassifier, init_params

    size = (VIT_IMAGE, VIT_IMAGE)
    model = ViTClassifier(cfg, num_classes, image_size=size,
                          use_kernels=use_kernels, device=dev)
    return model.load_params(init_params(cfg, num_classes, image_size=size,
                                         seed=seed))


def _vit_batch(torch, dev, b, num_classes, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"image": torch.rand(b, VIT_IMAGE, VIT_IMAGE, 3, generator=g,
                                device=dev),
            "label": torch.randint(0, num_classes, (b,), generator=g,
                                   device=dev)}


def _task_grads(torch, task, model, batch):
    """Loss, preds and every parameter's gradient (f32) of one step."""
    preds = task.forward(model, batch)
    loss, _ = task.loss_and_metrics(preds, batch)
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), preds, grads


# kernels against plain: f32 as phase 7e holds the LM and BERT (loss
# 1e-4, gradients 1e-4 relative L2 whole and each tensor); bf16 as 7e's
# bf16 step-0 (loss 1e-3, gradients 5e-2 whole, 1e-1 each tensor); the
# logits within the kernels' bf16 / f32 tolerance of their scale
P10_PARITY = {"float32": dict(loss=1e-4, rel=1e-4, worst=1e-4, logits=1e-4),
              "bfloat16": dict(loss=1e-3, rel=5e-2, worst=1e-1,
                               logits=3e-2)}


def _hold(torch, tag, name, got, want):
    """Kernels run ``got`` against plain run ``want``: (loss, logits,
    grads) within ``P10_PARITY[name]``."""
    lim = P10_PARITY[name]
    (loss_k, lk, gk), (loss_p, lp, gp) = got, want
    lk, lp = lk.detach().float(), lp.detach().float()
    rel, worst, worst_rel = _grad_diff(torch, gk, gp)
    scale = float(lp.abs().max())
    dlog = float((lk - lp).abs().max())
    log(f"  {tag} {name}: loss kernels {loss_k:.6f} vs plain {loss_p:.6f} "
        f"(tolerance {lim['loss']}); logits max diff {dlog:.2e} of scale "
        f"{scale:.3f} (tolerance {lim['logits']} x scale); gradients "
        f"relative L2 {rel:.2e} (tolerance {lim['rel']}), worst tensor "
        f"{worst} {worst_rel:.2e} (tolerance {lim['worst']})")
    check(all(bool(torch.isfinite(g).all()) for g in gk.values()),
          f"{tag} {name}: non-finite gradient")
    check(abs(loss_k - loss_p) <= lim["loss"]
          and dlog <= lim["logits"] * scale and rel <= lim["rel"]
          and worst_rel <= lim["worst"],
          f"{tag} {name}: the kernels disagree with the plain versions")


def check_vit_kernels(torch, dev):
    """Phase 14 (a): ViT at ViT-Base's width (hidden 768, 12 heads of 64,
    FFN 3072), 2 layers, batch 8 of 224^2, 10 classes, through the
    kernels and through ``use_kernels=False`` from one init, in bf16 and
    f32: loss, logits and every gradient; the kernels' launches of the
    kernels run gated at one forward + backward's count."""
    from pyspark_tf_gke_tpu_torch.models.bert import BertConfig
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS

    counters = _train_counters()
    task = TASKS["vit"]()
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        cfg = BertConfig(num_layers=2, dtype=dtype)
        batch = _vit_batch(torch, dev, 8, 10, seed=21)
        _reset(torch, counters)
        loss_k, pk, gk = _task_grads(torch, task, _vit_model(
            torch, dev, cfg, 10, 5), batch)
        torch.cuda.synchronize()
        launches = _moved(counters)
        loss_p, pp, gp = _task_grads(torch, task, _vit_model(
            torch, dev, cfg, 10, 5, use_kernels=False), batch)
        want = {"flash_attention_fwd": 2, "flash_attention_dq": 2,
                "flash_attention_dkv": 2, "layernorm": 6,
                "layernorm_bwd": 6}
        log(f"  ViT 2-layer {name}: launches of one step {launches} "
            f"(expected {want})")
        check(launches == want, f"ViT 2-layer {name}: launches {launches} "
              f"!= {want}")
        _hold(torch, "ViT 2-layer at ViT-Base width", name,
              (loss_k, pk["logits"], gk), (loss_p, pp["logits"], gp))


def run_vit_training(torch, dev):
    """Phase 14 (b): ViT-Base/16 trained at the JAX bench's shape through
    ``Trainer`` and ``TASKS["vit"]``: warm-up steps, then timed steps
    with every counter at 0 before them; each kernel's launches gated at
    ``VIT_PER_STEP`` a step; losses finite. Then two steps under the
    profiler. Returns the timed steps' launches."""
    from pyspark_tf_gke_tpu_torch.models.bert import BertConfig
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    counters = _train_counters()
    cfg = BertConfig()
    model = _vit_model(torch, dev, cfg, VIT_CLASSES, 0)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 86_569_192, f"ViT-Base has {n_params} parameters")
    trainer = Trainer(model, TASKS["vit"](), tx=make_optimizer(1e-3))
    state = trainer.init_state()
    batch = _vit_batch(torch, dev, VIT_BATCH, VIT_CLASSES, seed=22)
    warm, timed = VIT_STEPS
    losses = [float(trainer.step(state, batch)[1]["loss"])
              for _ in range(warm)]
    _reset(torch, counters)
    t0 = time.perf_counter()
    sums = []
    for _ in range(timed):
        sums.append(trainer.step(state, batch)[1]["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / timed
    launches = _moved(counters)
    losses += [float(x) for x in sums]
    log(f"  ViT-Base/16 ({n_params:,} parameters), batch {VIT_BATCH} x "
        f"{VIT_IMAGE}^2, bf16, Adam 1e-3: {ms:.2f} ms/step, "
        f"{VIT_BATCH / ms * 1e3:.1f} images/s ({timed} timed steps after "
        f"{warm}; {CARD})")
    log(f"  losses {[round(x, 4) for x in losses]}")
    log(f"  kernel launches over {timed} steps: {launches}")
    check(all(math.isfinite(x) for x in losses),
          f"non-finite ViT-Base loss {losses}")
    want = {k: n * timed for k, n in VIT_PER_STEP.items()}
    check(launches == want, f"ViT-Base launches {launches} != {want} "
          f"({VIT_PER_STEP} a step)")
    wall, busy, top = _profiled(
        torch, lambda: [trainer.step(state, batch) for _ in range(2)])
    check(busy > 0, "ViT-Base: torch.profiler saw no device time")
    log(f"  2 ViT-Base steps under the profiler: wall {wall:.2f} ms, device "
        f"busy {busy:.2f} ms ({100 * busy / wall:.1f}%), idle "
        f"{100 * (1 - busy / wall):.1f}%")
    for name, t in top[:12]:
        log(f"    {t:9.3f} ms  {name[:90]}")
    del trainer, state, model
    torch.cuda.empty_cache()
    return launches, {"ms": ms, "images_per_s": VIT_BATCH / ms * 1e3,
                      "busy_share": busy / wall}


def _moe_inputs(torch, model):
    """Forward pre-hooks recording each MoE layer's input, in order."""
    from pyspark_tf_gke_tpu_torch.models.moe import MoELayer

    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach()))
        for m in model.modules() if isinstance(m, MoELayer)]
    return seen, hooks


def _moe_replay(torch, model, inputs):
    """Forward pre-hooks giving each MoE layer the values ``inputs``
    recorded, with the gradient of its own input (a straight-through
    shift, exact in f32): both runs route the same tokens."""
    from pyspark_tf_gke_tpu_torch.models.moe import MoELayer

    it = iter(list(inputs))

    def hook(mod, args):
        x = args[0]
        want = next(it)
        shifted = x.float() + (want.float() - x.float()).detach()
        return (shifted.to(x.dtype),)

    return [m.register_forward_pre_hook(hook)
            for m in model.modules() if isinstance(m, MoELayer)]


def _picks(torch, model, inputs, k):
    """Each MoE layer's top-k expert picks on its recorded inputs."""
    from pyspark_tf_gke_tpu_torch.models.moe import MoELayer

    layers = [m for m in model.modules() if isinstance(m, MoELayer)]
    with torch.no_grad():
        return [torch.topk(torch.softmax(x.float() @ m.router, -1), k,
                           dim=-1).indices
                for m, x in zip(layers, inputs)]


def check_moe_kernels(torch, dev):
    """Phase 14 (c), first half: BERT-base widths with 8 experts, top 2,
    every 2nd layer, 2 layers, batch 8 x 128, through the kernels and
    through ``use_kernels=False`` from one init, in bf16 and f32. The
    plain run's MoE layer is handed the kernel run's input values (with
    its own gradient), so that both route the same tokens: the picks are
    checked equal, the aux loss equal, the loss, logits and gradients
    held as (a), the router's gradient within 1e-3 relative in f32 and
    5e-2 in bf16."""
    import dataclasses as dc

    from pyspark_tf_gke_tpu_torch.models.bert import BertConfig
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS

    cls = TASKS["bert_classification"]()
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        cfg = dc.replace(BertConfig(num_layers=2, dtype=dtype),
                         num_experts=8, moe_top_k=2, moe_every=2)
        batch = _bert_batch(torch, dev, cfg, 8, 60)
        runs, seen = {}, None
        for use_kernels in (True, False):
            model = _bert_model(torch, dev, cfg, 6, use_kernels)
            # the plain run: the kernel run's MoE inputs, then recorded
            hooks = [] if seen is None else _moe_replay(torch, model, seen)
            got, record = _moe_inputs(torch, model)
            loss, preds, grads = _task_grads(torch, cls, model, batch)
            for h in hooks + record:
                h.remove()
            seen = got if seen is None else seen
            router = grads["encoder.layer_1.moe.router"]
            runs[use_kernels] = (loss, preds, grads, router, got,
                                 _picks(torch, model, got, 2))
        (lk, pk, gk, rk, xk, ik), (lp, pp, gp, rp, xp, ip) = (runs[True],
                                                              runs[False])
        same = (all(bool(torch.equal(a, b)) for a, b in zip(xk, xp))
                and all(bool(torch.equal(a, b)) for a, b in zip(ik, ip)))
        aux_k, aux_p = (float(p["aux_loss"].detach()) for p in (pk, pp))
        r_rel = float((rk - rp).norm() / rp.norm().clamp_min(1e-30))
        r_tol = 1e-3 if dtype == torch.float32 else 5e-2
        log(f"  MoE-BERT 2-layer {name}: identical MoE inputs and picks "
            f"{same}; aux loss "
            f"kernels {aux_k:.6f} vs plain {aux_p:.6f} (1 under balanced "
            f"routing); router gradient relative L2 {r_rel:.2e} (tolerance "
            f"{r_tol}), norm {float(rk.norm()):.3e}")
        check(same, f"MoE-BERT {name}: the runs routed differently")
        check(aux_k == aux_p and math.isfinite(aux_k),
              f"MoE-BERT {name}: aux loss {aux_k} != {aux_p}")
        check(float(rk.norm()) > 0 and r_rel <= r_tol,
              f"MoE-BERT {name}: router gradients disagree ({r_rel})")
        _hold(torch, "MoE-BERT 2-layer", name,
              (lk, pk["cls_logits"], gk), (lp, pp["cls_logits"], gp))


def _bmm_ms(torch, fn):
    """Device ms of the batched products (``aten::bmm``: the MoE
    einsums' forward and backward products) in one call of ``fn``, and
    the device busy ms, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    bmm = busy = 0.0
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", None)
        if total is None:
            total = getattr(ev, "cuda_time_total", 0)
        if ev.key == "aten::bmm":
            bmm += total / 1e3
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            own = getattr(ev, "self_device_time_total", None)
            busy += (own if own is not None
                     else getattr(ev, "self_cuda_time_total", 0)) / 1e3
    return bmm, busy


def run_moe_bert(torch, dev):
    """Phase 14 (c), second half: ``bert_finetune`` at phase 7d's flags
    (BERT-base, bf16, batch 32 x 128) on 7d's shards, dense and then
    with ``--num-experts 8 --moe-every 2``, one epoch of
    ``MOE_BERT_STEPS`` steps each, every counter at 0 before each run:
    finite losses, ``moe_aux_loss`` finite (0 dense), K2/K3 launches
    equal. Then a dense and an MoE BERT-base step timed in turns (dense,
    MoE, MoE, dense; 5 steps each) and two MoE steps profiled for the
    einsums' share of device time. Returns the MoE run's launches."""
    import dataclasses as dc

    from pyspark_tf_gke_tpu_torch.models.bert import BertConfig
    from pyspark_tf_gke_tpu_torch.train.bert_finetune import main as bert_main
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    counters = _train_counters()
    work = PORT_PKG / "_build" / "chip_smoke_moe"
    shutil.rmtree(work, ignore_errors=True)
    pattern = write_bert_shards(work / "shards")
    runs = {}
    for tag, extra in (("dense", []), ("moe", MOE_FLAGS)):
        _reset(torch, counters)
        t0 = time.perf_counter()
        history = bert_main(["--data-pattern", pattern, *BERT_FLAGS, *extra,
                             "--epochs", "1", "--steps-per-epoch",
                             str(MOE_BERT_STEPS), "--output-dir",
                             str(work / tag), "--device", str(dev)])
        torch.cuda.synchronize()
        runs[tag] = (history, _moved(counters))
        log(f"  bert_finetune {tag} {' '.join(extra)}: "
            f"{time.perf_counter() - t0:.1f} s; {history}; launches "
            f"{runs[tag][1]}")
    hist, launches = runs["moe"]
    aux = hist["moe_aux_loss"][0]
    n_moe = BertConfig().num_layers // 2
    log(f"  MoE moe_aux_loss {aux:.6f}, summed over its {n_moe} MoE layers: "
        f"{aux / n_moe:.4f} a layer (1 under perfectly balanced routing); "
        f"dense {runs['dense'][0]['moe_aux_loss'][0]}")
    check(all(math.isfinite(x) for x in hist["loss"] + [aux]) and aux > 0,
          f"MoE bert_finetune: losses {hist['loss']}, aux {aux}")
    check(launches == runs["dense"][1], f"MoE bert_finetune launches "
          f"{launches} != dense {runs['dense'][1]}")
    shutil.rmtree(work, ignore_errors=True)
    trainers = {}
    for tag, cfg in (("dense", BertConfig()),
                     ("moe", dc.replace(BertConfig(), num_experts=8))):
        trainer = Trainer(_bert_model(torch, dev, cfg, 0),
                          TASKS["bert_classification"](),
                          tx=make_optimizer(1e-4))
        trainers[tag] = (trainer, trainer.init_state())
    batch = _bert_batch(torch, dev, BertConfig(), BERT_BATCH, 7)
    times = {"dense": [], "moe": []}
    for tag in ("dense", "moe", "moe", "dense"):
        trainer, state = trainers[tag]
        for _ in range(2):
            trainer.step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            trainer.step(state, batch)
        torch.cuda.synchronize()
        times[tag].append((time.perf_counter() - t0) * 1e3 / 5)
    trainer, state = trainers["moe"]
    bmm, busy = _bmm_ms(torch, lambda: [trainer.step(state, batch)
                                        for _ in range(2)])
    log(f"  BERT-base step, batch {BERT_BATCH} x {BERT_SEQ}, bf16, in turns "
        f"(dense, MoE, MoE, dense): dense {times['dense']} ms, MoE (8 "
        f"experts, top 2, every 2nd layer) {times['moe']} ms; {CARD}")
    log(f"  2 MoE steps under the profiler: the MoE einsums' batched "
        f"products {bmm:.2f} ms of {busy:.2f} ms device busy "
        f"({100 * bmm / max(busy, 1e-9):.1f}%)")
    del trainers
    torch.cuda.empty_cache()
    return launches, {"dense_ms": times["dense"], "moe_ms": times["moe"],
                      "einsum_share": bmm / max(busy, 1e-9)}


def _bootstrap(argv):
    """``etl.bootstrap.run(argv)``: its exit code and JSON summary."""
    import contextlib
    import io

    from pyspark_tf_gke_tpu_torch.etl import bootstrap

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bootstrap.run(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def run_etl_chain(torch, dev):
    """Phase 14 (d): the port's ``etl/bootstrap.py`` at its defaults
    (18,154 generated rows, k 25, 100 iterations) on ``cuda``, then on
    ``cpu`` over the same CSV: the summaries' rows, width, k, iterations
    and round trip equal, the silhouettes within 1e-3. Then the fit
    itself on both devices: ``n_iter`` equal, centres within 1e-3
    absolute + 1e-4 relative and cost within 1e-4 relative (f32
    products summed in another order; any assignments that differ are
    printed with their distance margins); the Lloyd iteration's device
    ms, the fit's and the silhouette's wall times."""
    import numpy as np

    from pyspark_tf_gke_tpu_torch.etl.feature_pipeline import FeaturePipeline
    from pyspark_tf_gke_tpu_torch.etl.kmeans import (KMeans, _sq_dists,
                                                     lloyd_step,
                                                     silhouette_score)
    from pyspark_tf_gke_tpu_torch.etl.workload import read_columns

    work = PORT_PKG / "_build" / "chip_smoke_etl"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    rc, cuda_sum = _bootstrap(["--out", str(work / "cuda"), "--device",
                               "cuda"])
    cuda_s = time.perf_counter() - t0
    csv = cuda_sum["dataset"]["path"]
    t0 = time.perf_counter()
    rc_cpu, cpu_sum = _bootstrap(["--out", str(work / "cpu"), "--csv", csv,
                                  "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    log(f"  bootstrap --device cuda ({cuda_s:.1f} s): {cuda_sum}")
    log(f"  bootstrap --device cpu ({cpu_s:.1f} s): {cpu_sum}")
    nc, np_ = cuda_sum["native_chain"], cpu_sum["native_chain"]
    check(rc == rc_cpu == 0 and cuda_sum["value"] == cpu_sum["value"] == 1,
          "the bootstrap failed")
    for key in ("rows_in", "rows_kept", "feature_width", "k", "iters",
                "silhouette_sample"):
        check(nc[key] == np_[key], f"bootstrap {key}: cuda {nc[key]} != "
              f"cpu {np_[key]}")
    for key in ("shards", "rows_written", "rows_read", "roundtrip_ok"):
        check(cuda_sum["bridge"][key] == cpu_sum["bridge"][key],
              f"bootstrap bridge {key} differs")
    check(cuda_sum["bridge"]["roundtrip_ok"], "the bridge lost rows")
    check(abs(nc["silhouette"] - np_["silhouette"]) <= 1e-3,
          f"silhouettes {nc['silhouette']} / {np_['silhouette']}")
    check(nc["rows_kept"] == 18154 and nc["k"] == 25,
          f"the bootstrap's defaults moved: {nc}")
    feats = FeaturePipeline().fit_transform(read_columns(csv))
    fits = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        km = KMeans(k=25, max_iter=100, seed=1, device=device).fit(feats)
        fit_s = time.perf_counter() - t0
        fits[device] = (km, fit_s, km.cost(feats), km.predict(feats))
    (kg, fit_g, cost_g, lab_g), (kc, fit_c, cost_c, lab_c) = (
        fits["cuda"], fits["cpu"])
    move = float(np.abs(kg.centers - kc.centers).max())
    differ = np.flatnonzero(lab_g != lab_c)
    log(f"  KMeans k 25 on {feats.shape}: n_iter cuda {kg.n_iter} / cpu "
        f"{kc.n_iter}; centres max diff {move:.3e}; cost {cost_g:.6f} / "
        f"{cost_c:.6f}; fit wall {fit_g:.3f} s on {CARD} / {fit_c:.3f} s "
        f"on the host; {differ.size} assignments differ")
    if differ.size:
        d = np.sort(_sq_dists(torch.from_numpy(feats[differ]),
                              torch.from_numpy(kc.centers)).numpy(), axis=1)
        log(f"    their distance margins (2nd - 1st nearest): "
            f"{(d[:, 1] - d[:, 0]).tolist()[:20]}")
    check(kg.n_iter == kc.n_iter, f"KMeans n_iter {kg.n_iter} != "
          f"{kc.n_iter}")
    check(bool(np.allclose(kg.centers, kc.centers, atol=1e-3, rtol=1e-4)),
          f"KMeans centres differ by {move}")
    check(abs(cost_g - cost_c) <= 1e-4 * abs(cost_c),
          f"KMeans cost {cost_g} != {cost_c}")
    x = torch.from_numpy(feats).to(dev)
    c = torch.from_numpy(kg.centers).to(dev)
    step_ms = cuda_ms(lambda: lloyd_step(x, c))
    rng = np.random.default_rng(0)
    sample = rng.choice(len(feats), 4096, replace=False)
    t0 = time.perf_counter()
    sil = silhouette_score(feats[sample], lab_g[sample], device=dev)
    sil_s = time.perf_counter() - t0
    log(f"  a Lloyd iteration over {feats.shape}: {step_ms:.4f} ms of device "
        f"(CUDA events); the silhouette over 4096 rows: {sil_s * 1e3:.1f} ms "
        f"wall ({sil:.4f}); {CARD}")
    shutil.rmtree(work, ignore_errors=True)
    return {"lloyd_ms": step_ms, "fit_s": fit_g, "silhouette_s": sil_s,
            "n_iter": kg.n_iter}


def check_faults_on_card(torch, dev):
    """Phase 14 (e): a CNN-B1 (f32) ``Trainer`` with ``mu_dtype=
    torch.bfloat16`` takes 5 steps on the card and on the host from the
    same init and batches (batch 8 at 64x80): the stored first moment
    bf16 on both, the losses within 1e-3 relative. Then the host seconds
    of the JAX-init replay for CNN-B1's 43.4M parameters at 256x320."""
    import numpy as np

    from pyspark_tf_gke_tpu_torch.data.pipeline import put_batch
    from pyspark_tf_gke_tpu_torch.models.cnn import CNNRegressor
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer
    from pyspark_tf_gke_tpu_torch.utils.seeding import jax_init_params

    images, targets = make_spot_arrays(40, 64, 80, seed=5)
    losses = []
    for device in (dev, torch.device("cpu")):
        trainer = Trainer(CNNRegressor(flat=True, dtype=None, device=device,
                                       image_size=(64, 80), seed=3),
                          TASKS["regression"](), learning_rate=1e-3,
                          mu_dtype=torch.bfloat16)
        state = trainer.init_state()
        out = []
        for i in range(5):
            batch = put_batch({"image": images[8 * i:8 * i + 8],
                               "target": targets[8 * i:8 * i + 8]}, device)
            out.append(float(trainer.step(state, batch)[1]["loss"]))
        dtypes = {m.dtype for m in state.opt_state["mu"].values()}
        check(dtypes == {torch.bfloat16}, f"stored first moment {dtypes}")
        losses.append(out)
    rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    log(f"  CNN-B1 f32, mu_dtype bf16, 5 steps: losses card "
        f"{losses[0]} / host {losses[1]} (max relative diff "
        f"{rel:.2e}, tolerance 1e-3); stored moment bf16")
    check(rel <= 1e-3, "mu_dtype=bf16 on the card disagrees with the host")
    meta = CNNRegressor(flat=True, image_size=(256, 320), device="meta")
    t0 = time.perf_counter()
    params = jax_init_params(meta, 1337)
    replay_s = time.perf_counter() - t0
    n = sum(int(np.prod(t.shape)) for t in params.values())
    log(f"  the JAX-init replay of CNN-B1 at 256x320 ({n:,} parameters): "
        f"{replay_s:.2f} s of host time")
    return {"replay_s": replay_s, "losses": losses}


def run_p10(torch, dev):
    """Phase 14, P10: (a) ViT kernels vs plain; (b) ViT-Base training;
    (c) MoE-BERT kernels vs plain, then ``bert_finetune --num-experts 8``
    against the dense run; (d) the native ETL chain on the card and the
    host, with every counter at 0 before it and read after (it runs no
    port kernel: the Lloyd products are cuBLAS calls, as the JAX ones are
    XLA's); (e) ``mu_dtype`` and the init replay's time. Returns the
    launches of (b), (c)'s MoE run and (d), and the figures."""
    t0 = time.perf_counter()
    log("  -- 14 (a) ViT kernels vs plain")
    check_vit_kernels(torch, dev)
    torch.cuda.empty_cache()
    log("  -- 14 (b) ViT-Base/16 training")
    vit_launches, vit = run_vit_training(torch, dev)
    log("  -- 14 (c) MoE-BERT")
    check_moe_kernels(torch, dev)
    torch.cuda.empty_cache()
    moe_launches, moe = run_moe_bert(torch, dev)
    log("  -- 14 (d) the native ETL chain")
    counters = _all_counters()
    _reset(torch, counters)
    etl = run_etl_chain(torch, dev)
    torch.cuda.synchronize()
    etl_launches = _moved(counters)
    check(not any(etl_launches.values()),
          f"the ETL chain launched port kernels: {etl_launches}")
    log("  -- 14 (e) mu_dtype on the card; the init replay")
    faults = check_faults_on_card(torch, dev)
    torch.cuda.empty_cache()
    log(f"  phase 14 took {time.perf_counter() - t0:.1f} s: {vit}, {moe}, "
        f"{etl}, {faults}")
    return vit_launches, moe_launches, etl_launches


# -- phase 15: the training mesh (P11a) ----------------------------------------

# lm_pretrain at its defaults (GPT-small: hidden 768, 12 layers, 12 heads,
# seq 512, global batch 16, byte tokenizer) for 2 epochs x 3 steps
P11_LM_FLAGS = ["--epochs", "2", "--steps-per-epoch", "3", "--seed", "0",
                "--learning-rate", "3e-4", "--heartbeat-every-steps", "0"]
# K2f, K2dq and K2dkv once a layer, K3 and K3b at each block's two norms
# and the final one, per GPT-small training step
P11_LM_PER_STEP = {"flash_attention_fwd": 12, "flash_attention_dq": 12,
                   "flash_attention_dkv": 12, "layernorm": 25,
                   "layernorm_bwd": 25}
# the mesh's losses against the run without one: the same f32 program
# (fsdp = tp = 1 places every parameter whole), so only the kernels'
# accumulation order can part them; bf16 to a rounding of its logits
P11_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 5e-3}


def _p11_lm(torch, dev, counters, pattern, work, dtype, mesh, tag):
    from pyspark_tf_gke_tpu_torch.train.lm_pretrain import main as lm_main

    argv = ["--data-pattern", pattern, *P11_LM_FLAGS, "--compute-dtype",
            dtype, "--output-dir", str(work / tag), "--device", str(dev)]
    if mesh:
        argv += ["--mesh-shape", "fsdp=1,tp=1"]
    _reset(torch, counters)
    history = lm_main(argv)
    torch.cuda.synchronize()
    shutil.rmtree(work / tag, ignore_errors=True)
    return history, _moved(counters)


def check_mesh_lm(torch, dev, counters, work):
    """(a) lm_pretrain at GPT-small width with ``--mesh-shape fsdp=1,tp=1``
    against the run without ``--mesh-shape``: bf16 in turns (plain,
    mesh, mesh, plain), then f32; the losses within P11_LOSS_RTOL, the
    training kernels launched the same number of times a step on both
    (P11_LM_PER_STEP). Returns the bf16 mesh run's launches."""
    import torch.distributed as dist

    pattern = write_corpus(work / "corpus")
    steps = int(P11_LM_FLAGS[1]) * int(P11_LM_FLAGS[3])
    want = {k: n * steps for k, n in P11_LM_PER_STEP.items()}
    mesh_launches = {}
    for dtype, order in (("bfloat16", (False, True, True, False)),
                         ("float32", (False, True))):
        runs = {False: [], True: []}
        for mesh in order:
            history, moved = _p11_lm(torch, dev, counters, pattern, work,
                                     dtype, mesh, f"{dtype}-{mesh}")
            runs[mesh].append(history)
            check(moved == want, f"lm_pretrain {dtype} (mesh {mesh}) "
                  f"launched {moved}, not {want}")
            if mesh:
                mesh_launches = moved
        plain, meshed = runs[False][0], runs[True][0]
        for a, b in zip(plain["loss"], meshed["loss"]):
            check(math.isfinite(b) and abs(a - b) <= P11_LOSS_RTOL[dtype]
                  * abs(a), f"{dtype} mesh loss {b} against {a}")
        log(f"  {dtype}: loss without a mesh {plain['loss']}, with "
            f"fsdp=1,tp=1 {meshed['loss']}")
        log(f"  {dtype} step_time_ms in turns (plain, mesh"
            f"{', mesh, plain' if len(order) == 4 else ''}): "
            + ", ".join(f"{'mesh' if m else 'plain'} "
                        f"{runs[m][order[:i].count(m)]['step_time_ms']}"
                        for i, m in enumerate(order)))
    check(dist.is_initialized() and dist.get_world_size() == 1
          and dist.get_backend() == "nccl",
          "the mesh run did not make a one-rank NCCL world")
    log(f"  kernel launches a mesh run ({steps} steps): {mesh_launches}")
    return mesh_launches


def check_mesh_resnet(torch, dev, counters):
    """(b) ResNet-50 fused3 (bf16, batch 64 of 224^2) on a ``dp=1`` mesh
    against no mesh, step by step in turns from the same weights: K4
    and K5 launched 36 and 13 times a step on both, the losses and the
    running statistics within bf16's tolerance."""
    from pyspark_tf_gke_tpu_torch.data.pipeline import put_batch
    from pyspark_tf_gke_tpu_torch.models.resnet import ResNet50
    from pyspark_tf_gke_tpu_torch.parallel.mesh import make_mesh
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    per_step = RESNET_PER_STEP["fused3"]
    mesh = make_mesh({"dp": 1}, dev)
    trainers = {}
    for tag, m in (("plain", None), ("mesh", mesh)):
        trainer = Trainer(ResNet50(norm_variant="fused3", device=dev,
                                   seed=0), TASKS["resnet"](),
                          learning_rate=1e-3, mesh=m)
        trainers[tag] = (trainer, trainer.init_state())
    batch = put_batch(resnet_batch(RESNET_BATCH, RESNET_IMAGE), dev)
    losses = {"plain": [], "mesh": []}
    times = {"plain": [], "mesh": []}
    launches = {}
    for i, tag in enumerate(("plain", "mesh", "mesh", "plain") * 2):
        trainer, state = trainers[tag]
        _reset(torch, counters)
        t0 = time.perf_counter()
        _, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        times[tag].append((time.perf_counter() - t0) * 1e3)
        losses[tag].append(float(metrics["loss"]))
        moved = _moved(counters)
        check(moved == per_step, f"ResNet-50 fused3 ({tag}) step launched "
              f"{moved}, not {per_step}")
        if tag == "mesh":
            launches = {k: launches.get(k, 0) + n for k, n in moved.items()}
    for a, b in zip(losses["plain"], losses["mesh"]):
        check(math.isfinite(b) and abs(a - b) <= 2e-3 * abs(a),
              f"ResNet-50 mesh loss {b} against {a}")
    plain_stats = trainers["plain"][1].batch_stats
    worst = 0.0
    for name, value in trainers["mesh"][1].batch_stats.items():
        ref = plain_stats[name]
        worst = max(worst, float((value - ref).abs().max()
                                 / ref.abs().max().clamp_min(1e-3)))
    check(worst <= 1e-2, f"ResNet-50 mesh running statistics {worst:.2e} "
          "of their scale from the run without a mesh")
    log(f"  losses, plain {losses['plain']}, mesh {losses['mesh']}; "
        f"running statistics within {worst:.2e} of their scale")
    log(f"  step ms in turns (the first of each is its warm-up): plain "
        f"{[round(t, 2) for t in times['plain']]}, mesh "
        f"{[round(t, 2) for t in times['mesh']]} ({CARD})")
    return launches


def check_mesh_bert(torch, dev, counters, work, launches_7d=None):
    """(c) bert_finetune at phase 7d's flags with ``--mesh-shape
    dp=1,sp=1``: the losses finite, and each training kernel launched
    as often a step as phase 7d's classification run launched it (2
    epochs x 10 steps there; with no ``launches_7d``, as a run of the
    same steps without a mesh launches it)."""
    from pyspark_tf_gke_tpu_torch.train.bert_finetune import main as bert_main

    pattern = write_bert_shards(work / "shards")
    epochs, steps = 2, 3
    runs = {}
    for mesh in ((False, True) if launches_7d is None else (True,)):
        _reset(torch, counters)
        history = bert_main(
            ["--data-pattern", pattern, *BERT_FLAGS, "--epochs", str(epochs),
             "--steps-per-epoch", str(steps), "--output-dir",
             str(work / f"bert-{mesh}"), "--device", str(dev)]
            + (["--mesh-shape", "dp=1,sp=1"] if mesh else []))
        torch.cuda.synchronize()
        runs[mesh] = (history, _moved(counters))
    history, moved = runs[True]
    log(f"  bert_finetune --mesh-shape dp=1,sp=1: loss {history['loss']}, "
        f"step_time_ms {history['step_time_ms']}; launches {moved}")
    check(all(math.isfinite(v) for v in history["loss"]),
          f"non-finite BERT mesh loss {history['loss']}")
    if launches_7d is None:
        ref, ref_steps = runs[False][1], epochs * steps
    else:
        ref, ref_steps = launches_7d, 20
    for name, n in ref.items():
        check(moved[name] * ref_steps == n * epochs * steps, f"{name}: "
              f"{moved[name]} launches in {epochs * steps} steps on the "
              f"mesh, {n} in {ref_steps} without one")
    shutil.rmtree(work, ignore_errors=True)
    return moved


# (d) two ranks on the one card: gloo takes the collectives the mesh
# calls on CUDA tensors (all_reduce, all_gather; ``kernel_probe.py
# gloo-cuda``: not point-to-point, nor DTensor's gather); NCCL refuses two
# ranks on a card. A 2-layer GPT-small in f32, 3 Adam steps of batch 16
# x 512 with padding that differs by row, on each mesh of 2 ranks
P11_PAIR_LM = dict(vocab_size=32000, hidden_size=768, num_layers=2,
                   num_heads=12, intermediate_size=3072, max_seq_len=512)
P11_PAIR_MESHES = ({"tp": 2}, {"dp": 2}, {"fsdp": 2})


def _p11_pair_batches():
    import numpy as np

    rng = np.random.default_rng(11)
    out = []
    for _ in range(3):
        lengths = rng.integers(256, 513, 16)
        out.append({"input_ids": rng.integers(0, 32000, (16, 512)).astype(
            np.int32), "attention_mask": (np.arange(512)[None]
                                          < lengths[:, None]).astype(
                                              np.int32)})
    return out


def _p11_pair_run(torch, dev, mesh):
    """3 steps of the 2-layer GPT-small on ``mesh`` (None: no mesh) from
    seed 0's parameters: ``(losses, each step's launches, the query
    heads this rank's kernels see)``."""
    from pyspark_tf_gke_tpu_torch.data.pipeline import put_batch
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLMConfig
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    cfg = CausalLMConfig(**P11_PAIR_LM, dtype=torch.float32)
    trainer = Trainer(_train_model(torch, dev, cfg, 0), TASKS["causal_lm"](),
                      tx=make_optimizer(1e-3), mesh=mesh)
    state = trainer.init_state()
    counters = _train_counters()
    losses, launches = [], []
    for batch in _p11_pair_batches():
        _reset(torch, counters)
        _, metrics = trainer.step(state, put_batch(trainer.local_batch(batch),
                                                   dev))
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        launches.append(_moved(counters))
    query = trainer.model.layer_0.attention.query.kernel
    return losses, launches, query.shape[1] // cfg.head_dim


def _p11_pair_rank(rank: int, port: int, out) -> None:
    """One of the two ranks on the card: every mesh of P11_PAIR_MESHES."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from pyspark_tf_gke_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        results = {}
        for axes in P11_PAIR_MESHES:
            results[json.dumps(axes)] = _p11_pair_run(
                torch, dev, make_mesh(axes, dev))
        out.put((rank, results))
    except Exception as exc:  # noqa: BLE001 — reported to the parent
        out.put((rank, f"{type(exc).__name__}: {exc}"))
        raise
    finally:
        dist.destroy_process_group()


def check_mesh_pair(torch, dev):
    """(d) the 2-layer GPT-small on meshes of two ranks of the one card
    (tp=2: each rank's 6 heads on the kernels, the vocabulary split; dp=2;
    fsdp=2) against the run without a mesh: losses within 1e-5 relative
    (f32), every rank's launches a step equal to it. Returns rank 0's
    launches over the tp=2 run."""
    import multiprocessing as mp
    import queue
    import socket

    want_losses, want_launches, _ = _p11_pair_run(torch, dev, None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_p11_pair_rank, args=(r, port, out))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, results = out.get(timeout=300)
            got[rank] = results
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
                p.join(10)
    log(f"  two ranks on the card: {time.perf_counter() - t0:.1f} s "
        f"(exit codes {[p.exitcode for p in procs]}); without a mesh: "
        f"losses {want_losses}, launches a step {want_launches[0]}")
    check(sorted(got) == [0, 1] and all(isinstance(r, dict)
                                        for r in got.values()),
          f"the two-rank runs did not finish: {got}")
    for axes in P11_PAIR_MESHES:
        key = json.dumps(axes)
        for rank in (0, 1):
            losses, launches, heads = got[rank][key]
            log(f"  {key} rank {rank}: losses {losses}; launches a step "
                f"{launches[0]}; {heads} query heads on the kernels")
            check(heads == P11_PAIR_LM["num_heads"] // axes.get("tp", 1),
                  f"{key} rank {rank}: {heads} query heads")
            for a, b in zip(want_losses, losses):
                check(abs(a - b) <= 1e-5 * abs(a),
                      f"{key} rank {rank}: loss {b} against {a}")
            check(launches == want_launches, f"{key} rank {rank}: "
                  f"launches {launches} against {want_launches}")
    tp = got[0][json.dumps({"tp": 2})][1]
    return {k: sum(step[k] for step in tp) for k in tp[0]}


def run_p11(torch, dev, launches_7d=None):
    """Phase 15: the training mesh on one card. A one-rank NCCL world
    (``make_mesh`` makes it: ``initialize_distributed`` is a no-op for
    one process, as the JAX one is) and (a)-(d) above; ``launches_7d``
    are phase 7d's classification launches (``None`` when the phase runs
    alone, ``kernel_probe.py check run_p11``)."""
    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc
    from pyspark_tf_gke_tpu_torch.ops import fused_matmul as fm

    work = PORT_PKG / "_build" / "chip_smoke_p11"
    shutil.rmtree(work, ignore_errors=True)
    counters = _train_counters()
    t0 = time.perf_counter()
    log("  (a) lm_pretrain, GPT-small, --mesh-shape fsdp=1,tp=1 against "
        "no mesh")
    lm = check_mesh_lm(torch, dev, counters, work)
    torch.cuda.empty_cache()
    log("  (b) ResNet-50 fused3 on a dp=1 mesh against no mesh")
    resnet = check_mesh_resnet(torch, dev, {
        "fused_matmul_fwd": (fm, "fwd_launches"),
        "fused_matmul_dx": (fm, "dx_launches"),
        "fused_matmul_dw": (fm, "dw_launches"),
        "fused_conv3_fwd": (fc, "fwd_launches"),
        "fused_conv3_dx": (fc, "dx_launches"),
        "fused_conv3_dw": (fc, "dw_launches")})
    torch.cuda.empty_cache()
    log("  (c) bert_finetune, BERT-base, --mesh-shape dp=1,sp=1")
    bert = check_mesh_bert(torch, dev, counters, work, launches_7d)
    torch.cuda.empty_cache()
    log("  (d) two ranks on the card (gloo): a 2-layer GPT-small at tp=2, "
        "dp=2 and fsdp=2 against no mesh")
    pair = check_mesh_pair(torch, dev)
    torch.cuda.empty_cache()
    log(f"  phase 15 took {time.perf_counter() - t0:.1f} s")
    return lm, resnet, bert, pair


# -- phase 16: tensor-parallel serving over the serve wire (P11b-serve) --------

# Every run of phase 16 serves with these flags, the tp pair and the
# one-process server alike (phase 4's slots and chunk, pieces of 256).
P16_FLAGS = ["--continuous-slots", "8", "--continuous-chunk", "16",
             "--prefill-chunk", "256"]
# The mix run adds the radix cache (pages of 64 tokens).
P16_RADIX = ["--prefix-cache", "32"]
# /v1/score under bf16 or int8 weights: the tp pair's row-parallel
# products are summed across the ranks after their own bf16 rounding, so
# each of 12 layers rounds once more than the one-process product; held
# to a mean NLL a token within 0.005 nats of the one-process server's
# (sound runs read at most 0.0024; the random GPT-small scores ~10.4
# nats a token, close to uniform, so the score alone is a weak check:
# the kernels are also held at the ranks' shapes, check_tp2_slices).
P16_NLL_TOL = 0.005
# the share of greedy tokens identical to the one-process server's, at
# least (sound runs read 0.78-0.94 over 4-10 prompts: a rounding flip
# between two near-equal logits changes every later token of its prompt,
# so two early flips in four prompts halve it; a wrong product changes
# nearly every token)
P16_SHARE_MIN = 0.25
# the counted traffic: sequential greedy requests (one at a time, so the
# engine runs the same ops on both servers), prompts of 20 to 700 tokens
# (the last two over --prefill-chunk: pieces), 16 new tokens (the first
# from the prompt, then one 16-step decode chunk), and one /v1/score
# batch
P16_COUNTED = ((20, 16), (100, 16), (300, 16), (700, 16))


def _p16_prompt(rng, n: int, vocab: int) -> str:
    """``n`` tokens of phase 16's word-level tokenizer (``w0``...: one
    word a token, so a completion's words ARE its token ids: the byte
    tokenizer would decode only the ids under 256 of a 32000-token
    model's output)."""
    return " ".join(f"w{rng.randrange(vocab - 3)}" for _ in range(n))


def _p16_cfgs(torch, tiny: bool):
    """``{name: (config, seed, quantize)}`` of phase 16's bundles: the
    GPT-small serving model (phase 4's, bf16 and int8) and its f32 copy
    at the 2-layer cut; ``tiny`` the CPU rehearsal's widths."""
    cfg = _serving_cfg()
    if tiny:
        cfg = dataclasses.replace(cfg, vocab_size=512, hidden_size=64,
                                  num_layers=2, num_heads=4,
                                  intermediate_size=128, max_seq_len=1024,
                                  kv_page_size=64, kv_num_pages=128)
    f32 = dataclasses.replace(cfg, num_layers=2, dtype=torch.float32)
    return {"bf16": (cfg, 0, False), "int8": (cfg, 0, True),
            "f32": (f32, 0, False)}


def _p16_rank(rank: int, port: int, device: str, plan, out) -> None:
    """One rank of the tp pair: ``serve.main`` once for each run of
    ``plan``, the kernels' counters set to 0 before each and reported
    with its exit code after it (rank 0 returns when its SIGTERM drain
    ends, rank 1 when rank 0 announces shutdown)."""
    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa
    from pyspark_tf_gke_tpu_torch.train import serve

    counters = _serve_counters()
    # NCCL refuses two ranks on one card: the pair joins a gloo world
    # itself, once, and every serve.main below keeps it
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        for name, argv in plan:
            _reset_serve(torch, counters)
            code = serve.main([a.format(rank=rank, port=port) for a in argv])
            if device == "cuda":
                torch.cuda.synchronize()
            out.put((rank, name, code, _moved(counters),
                     dict(pa.variant_launches)))
    except BaseException as exc:  # noqa: BLE001 — reported to the parent
        out.put((rank, "error", f"{type(exc).__name__}: {exc}", None, None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _reset_serve(torch, counters) -> None:
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    for variant in pa.variant_launches:
        pa.variant_launches[variant] = 0


def _p16_wait(url: str, proc, timeout_s: float = 300.0) -> dict:
    """Rank 0's ``/healthz`` once it answers (its process alive)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        check(proc.is_alive(), f"rank 0 exited ({proc.exitcode}) before "
              "serving")
        try:
            return _call(url, "/healthz")[2]
        except OSError:
            time.sleep(0.2)
    raise SmokeFailure(f"rank 0 did not serve {url} in {timeout_s} s")


def _p16_words(body: dict) -> list:
    """The generated tokens (words) of a one-prompt completion."""
    comp = body["completions"][0]
    return comp["completion"][len(comp["prompt"]):].split()


def _p16_greedy(url: str, prompts, new: int) -> list:
    """The tokens of sequential greedy requests (one at a time)."""
    out = []
    for prompt in prompts:
        status, _, body = _call(url, "/v1/generate", {
            "prompt": prompt, "max_new_tokens": new})
        check(status == 200, f"generate answered {status}: {body}")
        out.append(_p16_words(body))
    return out


def _p16_score(url: str, texts) -> list:
    status, _, body = _call(url, "/v1/score", {"texts": texts})
    check(status == 200, f"score answered {status}: {body}")
    return [(s["nll"], s["tokens"]) for s in body["scores"]]


def _p16_counted(urls, rng, vocab: int):
    """The counted traffic on each server of ``urls``: ``{url:
    (tokens, scores)}``."""
    prompts = [_p16_prompt(rng, n, vocab) for n, _ in P16_COUNTED]
    texts = [_p16_prompt(rng, n, vocab) for n in (40, 600)]
    return {url: (_p16_greedy(url, prompts, P16_COUNTED[0][1]),
                  _p16_score(url, texts)) for url in urls}


def _p16_nll_close(got, want, what: str) -> float:
    worst = 0.0
    for (a, n), (b, m) in zip(got, want):
        check(n == m, f"{what}: scored {n} tokens against {m}")
        worst = max(worst, abs(a - b) / n)
    check(worst <= P16_NLL_TOL, f"{what}: mean NLL a token off by {worst:.4f}"
          f" nats (limit {P16_NLL_TOL})")
    return worst


def _p16_share(got, want, what: str) -> float:
    """Share of generated tokens that agree position by position, held
    to ``P16_SHARE_MIN``."""
    same = sum(x == y for a, b in zip(got, want) for x, y in zip(a, b))
    share = same / max(sum(len(b) for b in want), 1)
    check(share >= P16_SHARE_MIN, f"{what}: greedy tokens identical to one "
          f"process {share:.4f} (floor {P16_SHARE_MIN})")
    return share


def _p16_step_ms(url: str) -> float:
    """ms a decode step at 8 live slots: 8 prompts of 16 tokens decoding
    192 new tokens (first tokens no earlier request shares, so no radix
    hit), then the median wall of the server's steps that decoded 8
    slots (``/stepz``; a step dispatches one 16-step chunk and collects
    the one before), over 16. Under announce the 8 requests admit one an
    op, over ~6 steps, so each must outlast them by a few chunks: 80 new
    tokens left one step at 8 slots."""
    prompts = [f"w{j} " + " ".join(["w99"] * 15) for j in range(8)]
    status, _, _ = _call(url, "/v1/generate", {"prompts": prompts,
                                               "max_new_tokens": 192})
    check(status == 200, f"timing request answered {status}")
    recs = _call(url, "/stepz?n=24")[2]["steps"]
    steps = [r["wall_ms"] for r in recs if r["decode_slots"] == 8]
    check(len(steps) >= 2, f"{len(steps)} steps at 8 slots: "
          f"{[(r['decode_slots'], r['wall_ms']) for r in recs]}")
    return statistics.median(steps) / 16


def _p16_mix(torch, url: str, one_url: str, rng, vocab: int) -> dict:
    """Phase 4's mix on the tp pair (12 requests from 3 clients, prompts
    of 20-700 tokens, 16-64 new, two of them sampled with their own
    seeds), a sampled request repeated, one SSE stream, a 4-beam
    request, a 600-token prompt and a second one sharing its first 512
    tokens (a radix hit), a /v1/score batch; the 12 jobs and the score
    also on the one-process server."""
    jobs = []
    for i in range(12):
        jobs.append({"prompt": _p16_prompt(rng, (20, 100, 300, 700)[i % 4],
                                           vocab),
                     "max_new_tokens": (16, 32, 48, 64)[(i * 7) % 4]})
        if i in (3, 8):
            jobs[-1].update(temperature=0.8, top_p=0.9, seed=100 + i)
    out = {}
    t0 = time.perf_counter()
    for which, target in (("tp", url), ("one", one_url)):
        results, errors = [None] * len(jobs), []

        def client(idx, target=target, results=results, errors=errors):
            for j in range(idx, len(jobs), 3):
                try:
                    results[j] = _call(target, "/v1/generate", jobs[j])
                except Exception as exc:  # noqa: BLE001 — reported below
                    errors.append(f"request {j}: {exc}")

        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(600)
        check(not errors, f"{which}: " + "; ".join(errors))
        for res in results:
            check(res is not None and res[0] == 200, f"{which}: {res}")
        out[which] = [_p16_words(r[2]) for r in results]
    sampled = [i for i, job in enumerate(jobs) if "seed" in job]
    again = _call(url, "/v1/generate", jobs[sampled[0]])
    check(again[0] == 200 and _p16_words(again[2]) == out["tp"][sampled[0]]
          and len(out["tp"][sampled[0]]) > 0, "a repeated sampled request "
          "gave other tokens on the tp pair")
    events, done, _, _ = _sse(url, {"prompt": _p16_prompt(rng, 60, vocab),
                                    "max_new_tokens": 24, "stream": True})
    check(done and events and events[-1].get("done"),
          f"the SSE stream did not finish: {events[-1:]}")
    beam = _call(url, "/v1/generate", {
        "prompt": _p16_prompt(rng, 80, vocab), "max_new_tokens": 16,
        "num_beams": 4})
    check(beam[0] == 200 and "beam_score" in beam[2]["completions"][0],
          f"the 4-beam request answered {beam[0]}")
    system = _p16_prompt(rng, 512, vocab)
    hits0 = _call(url, "/healthz")[2]["continuous"]["prefix_cache"]["hits"]
    for suffix in (_p16_prompt(rng, 88, vocab),
                   _p16_prompt(rng, 88, vocab)):
        res = _call(url, "/v1/generate", {"prompt": system + " " + suffix,
                                          "max_new_tokens": 16})
        check(res[0] == 200, f"a 600-token request answered {res[0]}")
    hits = _call(url, "/healthz")[2]["continuous"]["prefix_cache"]["hits"]
    check(hits > hits0, "the second 600-token prompt did not hit the radix "
          "cache")
    texts = [_p16_prompt(rng, n, vocab) for n in (40, 200, 600)]
    worst = _p16_nll_close(_p16_score(url, texts), _p16_score(one_url, texts),
                           "bf16 /v1/score")
    greedy = [i for i in range(len(jobs)) if i not in sampled]
    share = _p16_share([out["tp"][i] for i in greedy],
                       [out["one"][i] for i in greedy], "(a) the mix")
    log(f"  (a) mix: 12 jobs, a sampled repeat, an SSE stream, 4 beams, a "
        f"radix hit ({hits - hits0} hit), score worst {worst:.5f} nats a "
        f"token; greedy tokens identical to one process: {share:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"share": share, "nll_worst": worst}


def _p16_handoff(url: str, one_url: str, one_model, tokdir: str,
                 rng) -> None:
    """(d) ``/v1/prefill`` on one server feeds ``/v1/kv_import`` on the
    other, both ways; each then gives the tokens of its own prefill (f32:
    the one-process model's ``generate``)."""
    from pyspark_tf_gke_tpu_torch.data.text import get_tokenizer
    from pyspark_tf_gke_tpu_torch.models.causal_lm import generate

    tok = get_tokenizer(tokdir)
    vocab = one_model.cfg.vocab_size
    for src, dst, what in ((url, one_url, "tp -> one"),
                           (one_url, url, "one -> tp")):
        prefix = _p16_prompt(rng, 200, vocab)
        status, _, blob = _call(src, "/v1/prefill", {"prompt": prefix})
        check(status == 200 and blob["blob"], f"{what}: prefill {status}")
        status, _, imp = _call(dst, "/v1/kv_import", {"blob": blob["blob"]})
        check(status == 200 and imp["imported_tokens"] == blob["pages"] * 64,
              f"{what}: kv_import {status} {imp}")
        prompt = prefix + " " + _p16_prompt(rng, 30, vocab)
        got = _p16_greedy(dst, [prompt], 16)[0]
        ids = tok.encode(prompt)
        toks = generate(one_model, [ids], 16)[0, len(ids):].tolist()
        if tok.eos_id in toks:  # the server's entry ends at eos
            toks = toks[:toks.index(tok.eos_id)]
        check(got == tok.decode(toks).split(),
              f"{what}: the imported prefix gave other tokens")
        log(f"  (d) {what}: {blob['pages']} pages, the tokens of the "
            "importer's own prefill")


def _p16_launch_gate(runs, one, what: str, names, cuda: bool) -> None:
    """Each rank's launches equal the one-process server's (and, on the
    card, every kernel launched)."""
    for rank in (0, 1):
        got = runs[rank]
        for name in names:
            check((got[name] > 0 or not cuda) and got[name] == one[name],
                  f"{what} rank {rank}: {name} {got[name]} launches, one "
                  f"process {one[name]}")


# The shapes a rank of GPT-small's tp=2 pair gives the kernels: K6 on
# its weight slices, (K, N) (the query/key/value columns [768, 384], also
# as one grouped launch of three, out's rows [384, 768], mlp_in's columns
# [768, 1536], mlp_out's rows [1536, 768], the vocabulary-parallel lm_head
# [768, 16000]); K1 and K2f on its 6 query (and KV) heads: K1's (S,
# fills) of decode, the spec verify chunk and the 256-token piece, K2f's
# (B, S) of prefill and of a padded /v1/score batch (causal)
P16_INT8_SHAPES = ((768, 384), (384, 768), (768, 1536), (1536, 768),
                   (768, 16000))
P16_HEADS = 6
P16_PAGED = ((1, PAGED_FILLS), (1, SERVE_FILLS), (1, SPLIT_FILLS),
             (4, PAGED_FILLS), (256, PAGED_FILLS))
P16_FLASH = ((1, 20), (1, 100), (1, 256), (3, 600))


def check_tp2_slices(torch, dev) -> dict:
    """K6, K1 and K2f against their plain versions at the shapes a rank
    of the tp=2 pair gives them (``P16_*``), bf16 and f32; K6's plan
    (split-K cluster, columns a CTA) and K1's variant depend on these
    shapes, so each is checked at them. Returns each kernel's largest
    bf16 error."""
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa
    from pyspark_tf_gke_tpu_torch.ops import int8_matmul as im
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(23)
    errs = {"int8_matmul": 0.0, "paged_attention": 0.0,
            "flash_attention_fwd": 0.0}
    group = [_int8_weight(torch, dev, g, 768, 384) for _ in range(3)]
    weights = {(k, n): _int8_weight(torch, dev, g, k, n)
               for k, n in P16_INT8_SHAPES}
    h = P16_HEADS
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]

        def note(kernel, err, name=name):
            if name == "bfloat16":
                errs[kernel] = max(errs[kernel], err)

        for m in INT8_ROWS:
            for (k, n), (q, scale) in weights.items():
                x = torch.randn(m, k, generator=g, device=dev).to(dtype)
                before = im.launches
                out = im.int8_matmul(x, q, scale)
                check(im.launches == before + 1,
                      f"int8_matmul [{m},{k}]x[{k},{n}] did not count")
                note("int8_matmul", compare(
                    out, im.int8_matmul_plain(x, q, scale), name,
                    f"tp=2 rank: int8_matmul [{m},{k}]x[{k},{n}] {name} "
                    f"{im.int8_plan(m, k, n, dtype)}"))
            x = torch.randn(m, 768, generator=g, device=dev).to(dtype)
            before = im.launches
            outs = im.int8_matmul_group(x, group)
            check(im.launches == before + 1, "the grouped K6 call at "
                  "[768,384]x3 did not count one launch")
            plan = im.int8_plan(m, 768, (384,) * 3, dtype)
            for i, (out, (q, scale)) in enumerate(zip(outs, group)):
                note("int8_matmul", compare(
                    out, im.int8_matmul_plain(x, q, scale), name,
                    f"tp=2 rank: int8_matmul_group [{m},768]x3 [768,384] "
                    f"{name} output {i} {plan}"))
        for s, fill_list in P16_PAGED:
            if fill_list == SPLIT_FILLS:
                fill_list = _split_fills(torch, pa, h, s, h=h)
            q, kp, vp, table, fills, _, _ = _paged_case(
                torch, dev, g, dtype, h, s, False, fill_list, h=h)
            plan = pa.paged_plan(8, s, h, h, 64, 64, 16, dtype, kp.dtype)
            before = pa.variant_launches[plan.variant]
            out = pa.paged_attention_chunk(q, kp, vp, table, fills)
            check(pa.variant_launches[plan.variant] == before + 1,
                  f"K1 at H={h} did not launch its {plan.variant} variant")
            note("paged_attention", compare(
                out, pa.paged_attention_chunk_plain(q, kp, vp, table, fills),
                name, f"tp=2 rank: paged {name} slots=8 H=Hkv={h} S={s} "
                f"fills {list(fill_list)} ({plan.variant}: {plan.blocks} "
                f"row blocks of {plan.rows}, {plan.splits} splits)"))
        for b, s in P16_FLASH:
            q, k, v = (torch.randn(b, s, h, 64, generator=g, device=dev
                                   ).to(dtype) for _ in range(3))
            note("flash_attention_fwd", _flash_case(
                torch, fa, q, k, v, name,
                f"tp=2 rank: flash causal {name} B={b} S={s} H={h}")[2])
    log(f"  tp=2 rank shapes: K6 at {len(P16_INT8_SHAPES)} weight slices "
        f"and the [768,384]x3 group, K1 and K2f at {h} heads == their plain "
        f"versions; bf16 max_abs_err {errs}")
    return errs


def run_p16(torch, dev, tiny: bool = False):
    """Phase 16: ``serve.main --tp 2 --num-processes 2`` as two processes
    on the card (gloo), rank 0 on HTTP, against a one-process server of
    the same bundle in this process. Runs: (a) GPT-small bf16, the
    counted traffic then phase 4's mix; (b) the f32 copy at the 2-layer
    cut, then with a draft (the target's bundle) and ``--spec-tokens 3``;
    (c) int8 weights, the counted traffic; (d) the KV handoff both ways
    in (b); (e) the drain at the end of (c). On the card the kernels are
    first held at the ranks' shapes (:func:`check_tp2_slices`). ``tiny``
    rehearses it on the CPU. Returns rank 0's launches over the counted
    runs."""
    import multiprocessing as mp
    import os
    import queue
    import signal
    import socket

    from pyspark_tf_gke_tpu_torch.models.causal_lm import init_params
    from pyspark_tf_gke_tpu_torch.train.export import export_serving_bundle

    t_start = time.perf_counter()
    if dev.type == "cuda":
        check_tp2_slices(torch, dev)
    work = PORT_PKG / "_build" / "chip_smoke_p16"
    shutil.rmtree(work, ignore_errors=True)
    cfgs = _p16_cfgs(torch, tiny)
    vocab = cfgs["bf16"][0].vocab_size
    # one word a token: a completion's words are its tokens
    tokdir = _wordlevel_tokenizer_dir(work / "tokenizer", vocab)
    bundles, made = {}, []  # the int8 bundle quantizes the bf16 one's
    for name, (cfg, seed, quantize) in cfgs.items():
        params = next((p for c, s, p in made if c == cfg and s == seed),
                      None)
        if params is None:
            params = init_params(cfg, seed=seed)
            made.append((cfg, seed, params))
        bundles[name] = export_serving_bundle(cfg, params, str(work / name),
                                              quantize=quantize,
                                              tokenizer_spec=tokdir)
    log(f"  bundles exported in {time.perf_counter() - t_start:.1f} s")

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    ports = {run: free_port() for run in ("counted", "mix", "f32", "spec",
                                          "int8")}
    device = dev.type

    def argv(run, bundle, *extra):
        return (["--bundle", bundles[bundle], "--device", device, "--tp", "2",
                 "--num-processes", "2", "--process-id", "{rank}",
                 "--coordinator-addr", "127.0.0.1", "--coordinator-port",
                 "{port}", "--host", "127.0.0.1", "--port", str(ports[run]),
                 "--drain-timeout", "120"] + P16_FLAGS + list(extra))

    plan = [("counted", argv("counted", "bf16")),
            ("mix", argv("mix", "bf16", *P16_RADIX)),
            ("f32", argv("f32", "f32", *P16_RADIX)),
            # the draft is the target's bundle: it agrees, so rounds
            # accept and the accepted tokens advance both ranks' fills
            ("spec", argv("spec", "f32", "--draft-bundle", bundles["f32"],
                          "--spec-tokens", "3")),
            ("int8", argv("int8", "int8"))]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_p16_rank,
                         args=(r, port, device, plan, out))
             for r in range(2)]
    for p in procs:
        p.start()
    reports = {}
    counters = _serve_counters()
    rng = random.Random(16)
    one_kw = dict(prefill_chunk=256)

    def finish(run, inflight=None):
        """SIGTERM rank 0 (``inflight`` a request it must still answer
        while draining) and collect both ranks' reports of ``run``."""
        result = {}
        thread = None
        if inflight is not None:
            def go():
                result["inflight"] = _call(url(run), "/v1/generate",
                                           inflight)
            thread = threading.Thread(target=go)
            thread.start()
            time.sleep(0.5)
        os.kill(procs[0].pid, signal.SIGTERM)
        if thread is not None:
            thread.join(300)
        for _ in range(2):
            try:
                rank, name, code, launches, variants = out.get(timeout=300)
            except queue.Empty:
                raise SmokeFailure(f"{run}: a rank did not report") from None
            check(name == run and code == 0,
                  f"{run}: rank {rank} reported {name} {code}")
            reports[(run, rank)] = (launches, variants)
        log(f"  {run}: both ranks exited 0, {time.perf_counter() - t_start:.1f}"
            " s into phase 16")
        return result

    def url(run):
        return f"http://127.0.0.1:{ports[run]}"

    try:
        # (a) GPT-small bf16: the counted traffic
        health = _p16_wait(url("counted"), procs[0])
        check(health["tp"] == 2, f"/healthz tp {health['tp']}")
        cont = health["continuous"]
        log(f"  (a) rank 0 serving GPT-small bf16 at tp=2: the decode chunk "
            f"{'captured' if cont['captured'] else 'launched eagerly'} "
            f"({cont['decode_graphs']} graphs; gloo's collectives cannot be "
            "captured)")
        if device == "cuda":
            check(not cont["captured"], "the tp chunk claims a capture under"
                  " gloo")
        server, httpd, thread, one_url = _serve_bundle(
            torch, dev, bundles["bf16"], **one_kw)
        try:
            if device == "cuda":
                check(server.health()["continuous"]["captured"],
                      "the one-process chunk was not captured")
            _reset_serve(torch, counters)
            counted = _p16_counted([url("counted"), one_url], rng, vocab)
            one_launches = _moved(counters)
            finish("counted")
            tp_launches = [reports[("counted", r)][0] for r in (0, 1)]
            _p16_launch_gate(tp_launches, one_launches, "(a) bf16",
                             ("paged_attention", "flash_attention_fwd",
                              "layernorm"), device == "cuda")
            worst = _p16_nll_close(counted[url("counted")][1],
                                   counted[one_url][1], "(a) bf16 score")
            share = _p16_share(counted[url("counted")][0],
                               counted[one_url][0], "(a) counted")
            log(f"  (a) counted: launches on each rank {tp_launches[0]} == "
                f"one process {one_launches}; K1 by variant "
                f"{reports[('counted', 0)][1]}; score worst {worst:.5f} nats"
                f" a token; greedy tokens identical: {share:.4f}")
            # (a) phase 4's mix, and ms a decode step on each server
            _p16_wait(url("mix"), procs[0])
            mix = _p16_mix(torch, url("mix"), one_url, rng, vocab)
            steps = {"tp": _p16_step_ms(url("mix")),
                     "one": _p16_step_ms(one_url)}
            log(f"  (a) ms a decode step at 8 slots: tp=2 "
                f"{steps['tp']}, one process {steps['one']} on {CARD} (the "
                "tp pair's time is gloo's host staging of 25 collectives a "
                "step over two ranks on ONE card, not a tp speed)")
            finish("mix")
        finally:
            _unserve(server, httpd, thread)
        if device == "cuda":
            torch.cuda.empty_cache()
        # (b) the f32 copy at the 2-layer cut, and (d) the handoff
        _p16_wait(url("f32"), procs[0])
        server, httpd, thread, one_url = _serve_bundle(
            torch, dev, bundles["f32"], prefix_cache_size=32, **one_kw)
        try:
            prompts = [_p16_prompt(rng, n, vocab) for n, _ in P16_COUNTED]
            f32 = _p16_greedy(url("f32"), prompts, 24)
            one_f32 = _p16_greedy(one_url, prompts, 24)
            check(f32 == one_f32, "(b) f32 greedy tokens differ from the "
                  "one-process server's")
            _p16_handoff(url("f32"), one_url, server.model, tokdir, rng)
            finish("f32")
            _p16_wait(url("spec"), procs[0])
            spec = _p16_greedy(url("spec"), prompts, 24)
            check(spec == one_f32, "(b) --spec-tokens 3 with a draft gave "
                  "other tokens than spec off")
            spec_stats = _call(url("spec"), "/healthz")[2]["continuous"][
                "spec"]
            check(spec_stats["accept_rate"] > 0, "(b) the draft (the "
                  f"target's weights) accepted nothing: {spec_stats}")
            finish("spec")
            log(f"  (b) f32 at the 2-layer cut: greedy tokens == one process "
                f"(4 prompts x 24); with a draft (the target's weights) and "
                f"--spec-tokens 3 the same tokens, accept rate "
                f"{spec_stats['accept_rate']}")
        finally:
            _unserve(server, httpd, thread)
        # (c) int8 weights: the counted traffic, then (e) the drain
        _p16_wait(url("int8"), procs[0])
        server, httpd, thread, one_url = _serve_bundle(
            torch, dev, bundles["int8"], **one_kw)
        try:
            _reset_serve(torch, counters)
            counted = _p16_counted([url("int8"), one_url], rng, vocab)
            # (e) the drained request: in flight at rank 0's SIGTERM; the
            # one-process server then runs the same one, so the counts
            # still cover the same ops
            last = {"prompt": _p16_prompt(rng, 40, vocab),
                    "max_new_tokens": 48}
            drained = finish("int8", last)
            inflight = drained.get("inflight")
            check(inflight is not None and inflight[0] == 200,
                  f"(e) the request in flight at SIGTERM: {inflight}")
            check(_call(one_url, "/v1/generate", last)[0] == 200,
                  "the drained request failed on one process")
            one_int8 = _moved(counters)
            tp_int8 = [reports[("int8", r)][0] for r in (0, 1)]
            _p16_launch_gate(tp_int8, one_int8, "(c) int8",
                             ("int8_matmul", "paged_attention",
                              "flash_attention_fwd", "layernorm"),
                             device == "cuda")
            worst = _p16_nll_close(counted[url("int8")][1],
                                   counted[one_url][1], "(c) int8 score")
            share = _p16_share(counted[url("int8")][0], counted[one_url][0],
                               "(c) int8")
            k6 = server.model.k6_launches_per_step()
            log(f"  (c) int8: launches on each rank {tp_int8[0]} == one "
                f"process {one_int8} (K6 {k6} a decode step); score worst "
                f"{worst:.5f} nats a token; greedy identical {share:.4f}; "
                f"(e) the request in flight at SIGTERM answered "
                f"{inflight[2]['completions'][0]['new_tokens']} tokens")
        finally:
            _unserve(server, httpd, thread)
    finally:
        for p in procs:
            p.join(120)
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    check(codes == [0, 0], f"the tp pair exited {codes}")
    shutil.rmtree(work, ignore_errors=True)
    log(f"  (e) SIGTERM drained the request in flight; both ranks exited 0; "
        f"phase 16 took {time.perf_counter() - t_start:.1f} s")
    return {name: tp_launches[0][name] + tp_int8[0][name]
            for name in tp_launches[0]}


# -- main ---------------------------------------------------------------------


# the records' keys beyond the contract's that the kernels line carries
EXTRA_KEYS = ("graph_ms", "library_graph_ms", "library_contiguous_ms",
              "library_contiguous_graph_ms", "train_shape", "decode_shape",
              "full_pool", "piece", "d128", "d80", "launches_by_variant",
              "launches_by_variant_chunked", "vit_shape")
# kernels (substrings of ptxas's entry names) that must not spill: the
# tensor-core kernels (K1's chunk variant at D 64 and 128 among them),
# K1's decode variant and merge (D 64 and 128) and K6
NO_SPILL = ("wgmma", "paged_decode", "paged_merge", "int8_mm_hopper")
# (name, source, the TPU kernel it replaces, design of its bf16
# instantiation: "wgmma" on the tensor cores, "simt" on the CUDA cores;
# K1 by variant, K2 by head width)
FLASH_DESIGN = ("wgmma (bf16 at head_dim 64, 128), simt "
                "(csrc/flash_attention_simt.cu: other head_dim, f32)")
KERNELS = (
    ("layernorm", "pyspark_tf_gke_tpu_torch/csrc/layernorm.cu",
     "pyspark_tf_gke_tpu/ops/pallas/layernorm.py:37", "simt"),
    ("layernorm_bwd", "pyspark_tf_gke_tpu_torch/csrc/layernorm_bwd.cu",
     "pyspark_tf_gke_tpu/ops/pallas/layernorm.py:98", "simt"),
    ("flash_attention_fwd", "pyspark_tf_gke_tpu_torch/csrc/flash_attention.cu",
     "pyspark_tf_gke_tpu/ops/pallas/flash_attention.py:49", FLASH_DESIGN),
    ("flash_attention_dq",
     "pyspark_tf_gke_tpu_torch/csrc/flash_attention_bwd.cu",
     "pyspark_tf_gke_tpu/ops/pallas/flash_attention.py:162", FLASH_DESIGN),
    ("flash_attention_dkv",
     "pyspark_tf_gke_tpu_torch/csrc/flash_attention_bwd.cu",
     "pyspark_tf_gke_tpu/ops/pallas/flash_attention.py:215", FLASH_DESIGN),
    ("flash_attention_block", "pyspark_tf_gke_tpu_torch/ops/flash_attention.py",
     "pyspark_tf_gke_tpu/ops/pallas/flash_attention.py:456",
     "autograd entry over K2f, K2dq and K2dkv (csrc/flash_attention.cu, "
     "csrc/flash_attention_bwd.cu); " + FLASH_DESIGN),
    ("paged_attention", "pyspark_tf_gke_tpu_torch/csrc/paged_attention.cu",
     "pyspark_tf_gke_tpu/ops/pallas/paged_attention.py:124",
     "split-kv simt (decode, D 64 and 128), wgmma (chunk, D 64 and 128), "
     "rows (other head_dim, f32)"),
    ("fused_matmul_fwd", "pyspark_tf_gke_tpu_torch/csrc/fused_matmul.cu",
     "pyspark_tf_gke_tpu/ops/pallas/fused_matmul.py:91", "wgmma"),
    ("fused_matmul_dx", "pyspark_tf_gke_tpu_torch/csrc/fused_matmul.cu",
     "pyspark_tf_gke_tpu/ops/pallas/fused_matmul.py:178", "wgmma"),
    ("fused_matmul_dw", "pyspark_tf_gke_tpu_torch/csrc/fused_matmul.cu",
     "pyspark_tf_gke_tpu/ops/pallas/fused_matmul.py:246", "wgmma"),
    ("fused_conv3_fwd", "pyspark_tf_gke_tpu_torch/csrc/fused_conv3.cu",
     "pyspark_tf_gke_tpu/ops/pallas/fused_conv3.py:55", "wgmma"),
    ("fused_conv3_dx", "pyspark_tf_gke_tpu_torch/csrc/fused_conv3.cu",
     "pyspark_tf_gke_tpu/ops/pallas/fused_conv3.py:116", "wgmma"),
    ("fused_conv3_dw", "pyspark_tf_gke_tpu_torch/csrc/fused_conv3.cu",
     "pyspark_tf_gke_tpu/ops/pallas/fused_conv3.py:179", "wgmma"),
    # no pallas_call stands behind K6: it is the counterpart of XLA's
    # convert + scale fused into the matmul at inloop_dequantize
    ("int8_matmul", "pyspark_tf_gke_tpu_torch/csrc/int8_matmul.cu",
     "pyspark_tf_gke_tpu/ops/quant.py:136",
     "mma.sync m16n8k16 (bf16; f32 on the CUDA cores), split K as a "
     "thread-block cluster reduced through distributed shared memory, one "
     "launch a call, q/k/v and gate/in grouped (no TPU kernel: XLA's "
     "fused dequantize at inloop_dequantize)"),
)


def main() -> int:
    if not PORT_PKG.is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              f"({PORT_PKG} is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: the port runs on a "
              "CUDA card", file=sys.stderr)
        return 2
    t_main = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from pyspark_tf_gke_tpu_torch.device import resolve_device
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa
    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc
    from pyspark_tf_gke_tpu_torch.ops import fused_matmul as fm
    from pyspark_tf_gke_tpu_torch.ops import kernels
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("== 1. device")
    log(query_card())
    dev = resolve_device("cuda")  # raises unless capability 9.0
    cap = torch.cuda.get_device_capability(dev)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(dev)}, capability {cap[0]}.{cap[1]}")

    log("== 2. build")
    t0 = time.perf_counter()
    kernels.library()
    log(f"  kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc wall time {kernels.build_seconds})")
    for line in kernels.build_log.splitlines():
        if "Compiling entry function" in line or "Used " in line \
                or "spill" in line:
            log(f"  ptxas: {line.strip()[:150]}")
    for fn, info in ptxas_report(kernels.build_log).items():
        # the tensor-core kernels and K1's decode variant: none may spill
        if any(k in fn for k in NO_SPILL):
            log(f"  ptxas {fn[:90]}: {info['used']}; spill stores "
                f"{info['spill_stores']} B, spill loads "
                f"{info['spill_loads']} B")
            check(info["spill_stores"] == 0 and info["spill_loads"] == 0,
                  f"{fn} spills registers")
    for line in kernels.build_log.splitlines():
        if "warning" in line and "wgmma" in line:
            log(f"  ptxas: {line.strip()[:200]}")

    log("== 3. kernels vs plain versions")
    records = {"layernorm": check_layernorm(torch, dev),
               "layernorm_bwd": check_layernorm_bwd(torch, dev),
               "flash_attention_fwd": check_flash(torch, dev),
               **check_flash_bwd(torch, dev),
               "paged_attention": check_paged(torch, dev),
               **check_fused_matmul(torch, dev),
               **check_fused_conv3(torch, dev)}
    log("== 3b. K2 at head widths 128, 32 and 80; K1 at head_dim 128")
    for name, by_width in check_flash_widths(torch, dev).items():
        records[name].update(by_width)
    records["paged_attention"]["d128"] = check_paged_d128(torch, dev)
    block_counters = _block_counters()
    log("== 3c. the ring's block entry (flash_attention_block) and the "
        "4-block lse merge against K2f over the whole sequence")
    records["flash_attention_block"] = check_flash_block(torch, dev,
                                                         block_counters)
    ring_launches = check_ring_merge(torch, dev, block_counters)
    log("== 3d. K6, the int8-weight matmul, at GPT-small's and the cb "
        "--spec pair's widths")
    t_new = time.perf_counter()
    records["int8_matmul"] = check_int8_matmul(torch, dev)
    new_s = time.perf_counter() - t_new
    for name, rec in records.items():
        log(f"  {name} at {rec['shape']}: kernel_ms {rec['ms']:.4f}, "
            f"plain_ms {rec['plain_ms']:.4f}, library_ms "
            f"{rec['library_ms']:.4f}, bound_ms {rec['bound_ms']:.4f} "
            f"({rec['bound_by']})")

    serve_counters = _serve_counters()
    train_counters = _train_counters()
    # GPT-small (CausalLMConfig defaults: vocab 32000, hidden 768, 12
    # layers, 12 heads, FFN 3072, 1024 positions, bf16), paged as the
    # cb bench pages it: 64-token pages, slots x 16 of them
    cfg = _serving_cfg()
    log("== 4. serving main path: BundleServer + HTTP, GPT-small paged, "
        "8 slots")
    serve_launches, serve_variants, full_model = run_main_path(
        torch, dev, serve_counters, cfg)
    records["paged_attention"]["launches_by_variant"] = serve_variants
    log("== 4b. where a replayed decode chunk's time goes (torch.profiler)")
    profile_engine(torch, full_model)
    log("== 4d. the decode chunk as a captured CUDA graph against eager "
        "launches; decode-ahead depths 0, 1, 2; adaptive chunks")
    graph_launches = check_decode_graphs(torch, dev, full_model)
    log("== 5. serving parity on the card")
    check_parity(torch, dev, full_model, dataclasses.replace(
        cfg, num_layers=2, dtype=torch.float32))
    check_paged_piece(torch, dev, full_model)
    del full_model
    torch.cuda.empty_cache()
    log("== 4c. chunked prefill on the serving path: GPT-small at 2048 "
        "positions, 8 slots, pieces of 256 under a 384-token step budget")
    chunked_launches, chunked_variants = run_chunked_serving(
        torch, dev, serve_counters)
    records["paged_attention"]["launches_by_variant_chunked"] = \
        chunked_variants
    torch.cuda.empty_cache()
    log("== 4e. the radix prefix cache and the KV handoff: 16 requests "
        "sharing a 512-token system prompt, GPT-small, 4 slots")
    radix_launches, radix_variants = run_radix_serving(
        torch, dev, serve_counters)
    records["paged_attention"]["launches_by_variant_radix"] = radix_variants
    torch.cuda.empty_cache()
    log("== 4f. in-engine speculative decoding: the cb --spec pair, "
        "GPT-small with a self-draft and a random draft, the standalone "
        "driver")
    spec_launches, spec_pair = run_spec_serving(torch, dev, serve_counters)
    torch.cuda.empty_cache()
    log("== 4g. the replica's fleet contract: streams and the failover "
        "continuation, the KV handoff between a prefill and a decode "
        "server, deadlines, tenants, drain, /loadz")
    fleet_launches = run_fleet_contract(torch, dev, serve_counters)
    torch.cuda.empty_cache()
    log("== 4h. the replica's operator contract: beam search, hot reload "
        "with canary and rollback, /admin/profile, the step watchdog, "
        "/metrics /events /traces, a Hugging Face tokenizer")
    ops_launches, _ = run_operator_contract(torch, dev, serve_counters)
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    log("== 4i. int8 weights resident: GPT-small loaded from an int8 and a "
        "bf16 bundle, its decode chunk on each")
    paged_chunk = check_resident(torch, dev)
    torch.cuda.empty_cache()
    log("== 4j. the dense slot-cache engine: a dense GPT-small bundle over "
        "HTTP, prefix LRU, chunked prefill, speculation")
    dense_launches = run_dense_serving(torch, dev, serve_counters, spec_pair,
                                       paged_chunk)
    del spec_pair
    torch.cuda.empty_cache()
    new_s += time.perf_counter() - t_new
    log(f"  phases 3d, 4i and 4j took {new_s:.1f} s")
    log("== 6. training main path: lm_pretrain, GPT-small width, bf16, "
        "batch 16 x 512")
    train_launches, _ = run_training(torch, dev, train_counters)
    log("== 6b. where a training step's time goes (torch.profiler)")
    profile_training(torch, dev)
    torch.cuda.empty_cache()
    log("== 6c. the rest of the LM training plane at vocab 50257: token "
        "shards, chunked CE, Adafactor and LAMB, async checkpoints, "
        "lm_eval")
    plane_launches, eval_launches, _ = run_lm_plane(torch, dev)
    torch.cuda.empty_cache()
    log("== 7. training parity on the card")
    check_training_parity(torch, dev)
    torch.cuda.empty_cache()
    log("== 7b. a training step at GPT-2 large's widths (hidden 1280, 20 "
        "heads): LayerNorm at D = 1280")
    wide_launches = check_wide_lm_step(torch, dev, {
        "layernorm": (ln, "launches"), "layernorm_bwd": (ln, "bwd_launches")})
    torch.cuda.empty_cache()
    log("== 7c. head_dim 128 (hidden 1024, 8 heads): a training step and a "
        "served bundle")
    d128_launches, d128_served = check_d128_lm(torch, dev, train_counters)
    torch.cuda.empty_cache()
    log("== 7d. BERT fine-tuning main path: bert_finetune, BERT-base, bf16, "
        "batch 32 x 128, classification then MLM")
    bert_launches = run_bert_training(torch, dev, train_counters)
    torch.cuda.empty_cache()
    log("== 7e. BERT training parity on the card: kernels vs plain")
    check_bert_parity(torch, dev)
    torch.cuda.empty_cache()

    k4_counters = {"fused_matmul_fwd": (fm, "fwd_launches"),
                   "fused_matmul_dx": (fm, "dx_launches"),
                   "fused_matmul_dw": (fm, "dw_launches")}
    k5_counters = {"fused_conv3_fwd": (fc, "fwd_launches"),
                   "fused_conv3_dx": (fc, "dx_launches"),
                   "fused_conv3_dw": (fc, "dw_launches")}
    resnet_counters = {**k4_counters, **k5_counters}
    log("== 8. ResNet-50 training main path: Trainer, norm_variant=fused, "
        "bf16, batch 64 x 224^2")
    resnet_launches, trainer, state, batch = run_resnet_training(
        torch, dev, resnet_counters, "fused")
    log("== 8b. where a ResNet-50 fused step's time goes (torch.profiler), "
        "and the bn variant's step")
    fused_ms = time_resnet(torch, trainer, state, batch, "fused")
    del trainer, state
    torch.cuda.empty_cache()
    bn_ms = time_bn_resnet(torch, dev, batch)
    del batch
    log(f"  fused / bn = {fused_ms / bn_ms:.2f}")
    log("== 9. ResNet-50 fused training parity on the card: kernels vs "
        "plain")
    check_resnet_parity(torch, dev, "fused")
    log("== 10. ResNet-50 training main path: Trainer, norm_variant=fused3, "
        "bf16, batch 64 x 224^2")
    fused3_launches, trainer, state, batch = run_resnet_training(
        torch, dev, resnet_counters, "fused3")
    log("== 10b. where a ResNet-50 fused3 step's time goes (torch.profiler)")
    fused3_ms = time_resnet(torch, trainer, state, batch, "fused3")
    log(f"  fused3 / fused = {fused3_ms / fused_ms:.2f}, fused3 / bn = "
        f"{fused3_ms / bn_ms:.2f} (fused {fused_ms:.2f}, bn {bn_ms:.2f} "
        "ms/step, phase 8b)")
    del trainer, state, batch
    torch.cuda.empty_cache()
    log("== 11. ResNet-50 fused3 training parity on the card: kernels vs "
        "plain")
    check_resnet_parity(torch, dev, "fused3")
    log("== 12. the other ResNet-50 variants: one training step each, "
        "bf16, 8 x 64^2")
    check_resnet_variants(torch, dev, k5_counters)
    torch.cuda.empty_cache()
    log("== 13. the reference-parity training plane (P9): CNN-B1 and MLP "
        "loss parity, train.cli in image and CSV mode with a fault and a "
        "resume, the image checker, where a CNN-B1 step goes")
    p9_launches = run_p9(torch, dev)
    log("== 14. P10: K2f/K2dq/K2dkv at ViT-Base's S = 197; ViT kernels vs "
        "plain and ViT-Base/16 training; the MoE FFN in BERT-base; the "
        "native ETL chain on the card and the host; mu_dtype on the card")
    for name, rec in check_flash_s197(torch, dev).items():
        records[name]["vit_shape"] = rec
    vit_launches, moe_launches, etl_launches = run_p10(torch, dev)
    log("== 15. P11a, the training mesh on one card: lm_pretrain at "
        "GPT-small and bert_finetune on meshes of one rank, ResNet-50 "
        "fused3 at dp=1, each against its run without a mesh")
    mesh_lm, mesh_resnet, mesh_bert, mesh_pair = run_p11(torch, dev,
                                                         bert_launches)
    torch.cuda.empty_cache()
    log("== 16. P11b-serve, tensor-parallel serving over the serve wire: "
        "serve.main --tp 2 --num-processes 2 as two processes on the card "
        "(gloo), GPT-small bf16 and int8 and its f32 2-layer cut, against "
        "a one-process server of each bundle")
    tp_serve = run_p16(torch, dev)

    out = []
    for name, source, replaces, design in KERNELS:
        rec = records[name]
        per_path = {"serve": serve_launches.get(name, 0),
                    "serve_graphs": graph_launches.get(name, 0),
                    "serve_chunked": chunked_launches.get(name, 0),
                    "serve_radix": radix_launches.get(name, 0),
                    "serve_spec": spec_launches.get(name, 0),
                    "serve_fleet": fleet_launches.get(name, 0),
                    "serve_ops": ops_launches.get(name, 0),
                    "serve_dense": dense_launches.get(name, 0),
                    "lm_train": train_launches.get(name, 0),
                    "lm_plane_train": plane_launches.get(name, 0),
                    "lm_eval": eval_launches.get(name, 0),
                    "lm_train_1280": wide_launches.get(name, 0),
                    "lm_train_d128": d128_launches.get(name, 0),
                    "serve_d128": d128_served.get(name, 0),
                    "resnet_train": resnet_launches.get(name, 0),
                    "resnet_fused3_train": fused3_launches.get(name, 0),
                    "bert_train": bert_launches.get(name, 0),
                    "ring_merge": ring_launches.get(name, 0),
                    "p9_train": p9_launches[name],
                    "vit_train": vit_launches.get(name, 0),
                    "moe_bert_train": moe_launches.get(name, 0),
                    "p10_etl": etl_launches[name],
                    "mesh_lm_train": mesh_lm.get(name, 0),
                    "mesh_resnet_fused3_train": mesh_resnet.get(name, 0),
                    "mesh_bert_train": mesh_bert.get(name, 0),
                    "mesh_pair_tp2_lm_train": mesh_pair.get(name, 0),
                    "serve_tp2_rank0": tp_serve.get(name, 0)}
        # each kernel's count from the path that runs it, the newest
        # slice's path first (paged attention runs only on serving; the
        # block entry on the ring, phase 3c's merge on one card)
        if name == "flash_attention_block":
            launches = per_path["ring_merge"]
        elif per_path["serve_tp2_rank0"]:
            # K1, K2f, K3 and K6 on the tp=2 serving path (phase 16)
            launches = per_path["serve_tp2_rank0"]
        else:
            launches = (per_path["mesh_bert_train"]
                        or per_path["mesh_resnet_fused3_train"]
                        or per_path["vit_train"] or per_path["bert_train"]
                        or per_path["resnet_fused3_train"]
                        or per_path["resnet_train"] or per_path["lm_train"]
                        or per_path["serve"])
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "design": design,
                    "launches": launches,
                    "launches_per_path": per_path,
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"],
                    **{key: rec[key] for key in EXTRA_KEYS if key in rec}})
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_main:.1f}"
        f" s on {CARD}")
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
