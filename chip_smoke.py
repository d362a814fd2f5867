#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero; no result line is printed then).
The phases on gloo rank processes (4's tp 2 and dp 2 x tp 2 runs, 19-33,
35) run their single-process part in the order below, up to their ranks;
their rank work then runs on one set of four rank processes (4's dp 2 x
tp 2, then 24, 25, 28, 29, 31, 33, 35's training, 37, 38) and one set of two
(4's tp 2, tp 2 families and CP runs, then 19 with 26, 35's serving, 23,
21 with 32, 22, 27 with 30),
each phase's in turn on the same processes (``_run_jobs``: a process's
start costs seconds), and each phase's checks after its set:

1. the card: ``torch.cuda.is_available()`` or exit 1; name and power
   limit from ``nvidia-smi``;
2. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, started together) and print ptxas's register / shared-memory
   / spill lines, and the HGMMA (wgmma) and UTMALDG (TMA load) counts in
   the SASS of the tensor-core kernels (flash, the fused MLP, bf16 paged
   attention; ``cuobjdump -sass``; each must be > 0 where the toolkit has
   cuobjdump);
3. hold each kernel against its plain PyTorch version on the card at the
   shapes of its path (bf16) and at small fp32 shapes, with the
   tolerance stated beside each (flash attention also on ragged,
   windowed and non-causal inputs, and its gradients; the bf16 flash and
   fused-MLP checks are per value, and each is shown to reject a
   defective plain variant; both also at every shape the split path of
   phase 5b gives them: flash at each prefill bucket of one prompt, 32 to
   1024 positions, and at generate's 4 x 512, the fused MLP at 4, 32,
   64, 128, 512, 1024 and 2048 rows, and on 16 draws of x at each of
   those row counts and at 256, beside the plain version's and the
   kernel's distance from an exactly rounded h); bf16 paged attention
   also per
   value against the Pallas arithmetic (P fp32), shown to reject a run
   with one live page dropped, on a tile straddling two slots, rows
   whose tables agree on their first pages only, a lone 1024-token row
   (split), the decode-only mix and the split path's 4-row decode table
   (with and without an idle slot; a dropped page rejected there too),
   its device plan equal to ``tile_plan``, two identical calls equal bit
   for bit, one row's output equal bit for bit alone, in runs of its
   slot's rows and beside rows of slots sharing its pages at kv_len 255,
   256, 257, 700, 1024 and 4096, each with page tables of 1, 2 and 4
   times the width its rows need (the row-alone check), and timed at the
   T = 256 and decode-only mixes and four lone 4096-key decode rows (by
   CUDA-graph replay, and eager with its host path); the SSD scan in
   bf16 at the SSM prefill's shape (b 1, s 1024, h 48, p 64, n 128,
   chunk 128; x, B, C read in place as views of one conv-output buffer)
   with y within atol 1e-5 + rtol 8e-3 of each value and the final state
   within 1e-4 of its largest value (and the check shown to reject a
   scan that drops the carried state), and in fp32 at small shapes with
   a ragged chunk (s 77 at chunk 128) and several chunks (s 96 at chunk
   32) within 1e-4, and faster than its plain version; time kernel, plain
   version and one PyTorch library call computing the same function
   (never called by the port; none exists for the SSD scan) with CUDA
   events, each launch of the multi-launch kernels by torch.profiler, and
   compute each kernel's bound from these inputs and NVIDIA's H100 SXM
   data sheet; then the same three checks (each shown again to reject a
   defective variant), times and bounds at the hybrid's shapes (phase
   11's Zamba2-1.2B): flash at (1, S, S, 32, 32, 64) for S 128, 256, 640
   and 1024 and at (4, 512, 512, 32, 32, 64) beside SDPA, the fused MLP at
   d 2048, f 8192 for T 4, 77, 256 and 1024 beside three matmuls (and the
   16-seed sweep at T 256 and 1024), the SSD scan at (1, s, 64, 64, 64),
   chunk 128, for s 128 and 1024; these small calls time by CUDA-graph
   replay (their host path outlasts their device work), eager beside;
   then at OLMoE-1B-7B's heads (phases 13, 13b and 14: Hq = Hkv = 16, D
   128, so rep 1): bf16 paged attention at the T = 256 mix, the
   decode-only mix and the split path's 4-row decode table with and
   without an idle slot, per value against the fp32-P plain version and
   within 1e-2 of the gather, its device plan equal to ``tile_plan``, the
   check shown to reject a dropped live page, the two mixes timed by
   graph replay beside SDPA on the gathered KV with their bound; flash at
   (1, S, S, 16, 16, 128) for each of phase 13b's prefill lengths (phase
   5's six prompt lengths, exact: an MoE prefill is not bucketed, and the
   profiled pair's 600 and 40) and phase 14's S 4096, per value (shown to
   reject dropped keys), timed beside SDPA with its bound; then at
   whisper-tiny's heads (phases 15, 15b and 16: Hq = Hkv = 6, D 64):
   bf16 paged attention at phase 15's T = 256 mix and decode-only mix
   over 8 slots x 448 tokens (both timed beside SDPA with their bound)
   and at the split path's 8-row decode table, per value, device plan =
   ``tile_plan``, a dropped live page rejected; flash non-causal at the
   encoder's (1, 1500, 1500, 6, 6, 64) and the training step's (8, 1500,
   1500, 6, 6, 64), each shown to reject a version that drops the last,
   ragged key tile (keys 1408-1499), and causal at each of phase 15b's
   prompt lengths and at (8, 448, 448, 6, 6, 64), each shown to reject
   dropped keys; all per value, timed beside SDPA with their bound; then
   at Llama-3.2-Vision-90B's shapes (phases 17 and 18): flash causal at
   (1, S, S, 64, 8, 128) — GQA rep 8 — for each of phase 17's prompt
   lengths and S 2048 and 4096 (phase 18), the fused MLP at d 8192, f
   28672 (weights at the uncut 100-layer model's init scales, which
   phase 17 keeps) for T 4 (the decode step) and each prompt length,
   each per value
   and shown to reject its defect, timed beside SDPA / three matmuls with
   its bound, the MLP on 16 draws of x at T 4 and at the shortest and the
   longest prompt (its 1.4 GB weight set freed after); then at
   tensor-parallel Qwen3-14B's rank shapes (``TP_SHAPES``): at tp 2
   (phase 19's: 20/4 heads x 128, d_ff 8704 a rank) paged attention at
   the T = 256 mix and the split path's 4-row decode table, the fused MLP
   at d 5120, f 8704 for T 256 and each of phase 5b's row counts, flash
   at (1, S, S, 20, 4, 128) for each of phase 5b's prefill buckets, each
   per value, shown to reject its defect and timed beside SDPA / three
   matmuls with its bound; at tp 4 (10/2 heads, f 4352) and tp 8 (5/1
   heads, f 2176), which a box of 4 or 8 cards would launch, the three
   at T = 256, per value, untimed; then at the rank shapes of phases 21
   and 22 (tp 2): paged attention at OLMoE-1B-7B's 8/8 heads x 128 (the
   T = 256 mix, the 4-row split decode table) and at whisper-tiny's 3/3
   x 64 (its T = 256 mix over 8 slots x 448, the 8-row split decode
   table), flash at (1, S, S, 8, 8, 128) for each of phase 21's prompt
   lengths and at whisper-tiny's (1 | 8, 1500, 1500, 3, 3, 64)
   non-causal and (1, S, S, 3, 3, 64) causal at each of phase 22's
   prompt lengths; each per value, its defect rejected, timed beside
   SDPA with its bound; then at the shapes phase 23 adds: bf16 flash at
   (1, 8192, 8192, 20, 4, 128) causal and the fused MLP at d 5120, f 8704
   for T 8192 and T 1, each per value, its defect rejected, timed beside
   SDPA / three matmuls with its bound; its f32 check's shapes in fp32:
   flash at (1, 1024, 1024, 20, 4, 128) within 2e-6 and the MLP at T 1024
   and T 1 within 1e-5, each shown to reject its defect; then at the
   shapes phase 24 adds: bf16 flash at a tp 2 training rank's (1, 2048,
   2048, 20, 4, 128) causal, per value, its defect rejected, timed beside
   SDPA with its bound and its plain backward timed; fp32 flash at the
   f32 check's (1, 256, 256, 20, 4, 128) and (2, 256, 256, 40, 8, 128)
   within 2e-6, each shown to reject dropped keys; then at the shapes
   phase 25 adds: bf16 flash at a pipeline stage's (1, 2048, 2048, 40,
   8, 128) causal the same way, and fp32 at its f32 check's (1, 256,
   256, 40, 8, 128); then at the shapes phase 27 adds: the SSD scan in
   bf16 at a tp 2 rank's (1, S, 24, 64, 128) (Mamba2-780M) and (1, S,
   32, 64, 64) (Zamba2-1.2B) for each of phases 7's and 11's six prompt
   lengths, flash at Zamba2's (1, S, S, 16, 16, 64) for each and the
   fused MLP at its d 2048, f 4096 for T 4 and each, per value, each
   defect rejected, timed beside its library call (SDPA, three matmuls;
   none for the SSD scan) with its bound; then at the shapes phase 29
   adds: bf16 flash at a dp 2 x tp 2 whisper-tiny training rank's (4,
   1500, 1500, 3, 3, 64) non-causal (the encoder, the last key tile
   dropped as the defect) and (4, 448, 448, 3, 3, 64) causal (the
   decoder), each per value, its defect rejected, timed beside SDPA with
   its bound and its plain backward timed; fp32 at the f32 check's rank
   shapes (1, 1500 | 448, ..., 3, 3, 64) and one-device shapes (2, 1500 |
   448, ..., 6, 6, 64), non-causal and causal, within 2e-6, each shown to
   reject dropped keys; then at the shapes phases 30 and 31 add
   (Llama-3.2-Vision-90B at a tp 2 rank: 32/4 heads x 128, d_ff 14336):
   bf16 flash causal at (1, S, S, 32, 4, 128) for each of phase 17's
   prompt lengths and at a dp 2 x tp 2 training rank's (1, 1024, 1024,
   32, 4, 128) (its plain backward timed), the fused MLP at d 8192, f
   14336 for the split path's 4 decode rows and each prompt length, each
   per value, its defect rejected, timed beside SDPA / three matmuls with
   its bound; fp32 flash at the f32 checks' shapes (phase 31's (1, 256,
   256, 32, 4, 128) and (2, 256, 256, 64, 8, 128), phase 30's prefills at
   the shortest and the longest prompt at 32/4 and 64/8 heads) within
   2e-6 and the fp32 MLP at f 14336 and 28672 for 4 rows and the longest
   prompt per value (atol 1e-5 + rtol 1e-4), each rejecting its defect;
   then at the shapes phase 33 adds: bf16 flash at a dp 2 x tp 2
   OLMoE-1B-7B training rank's (1, 2048, 2048, 8, 8, 128) causal, per
   value, its defect rejected, timed beside SDPA with its bound and its
   plain backward timed; fp32 flash at the f32 check's rank shape (1,
   256, 256, 8, 8, 128) and one-device shape (2, 256, 256, 16, 16, 128)
   within 2e-6, each shown to reject dropped keys;
4. tiny float32 configs on the card and on the CPU (TF32 off): through
   the port's engine on each layout — the mixed step, the split path on
   the pool (``mixed=False``) and on the dense layout (``paged=False``),
   and the sliding-window ring — first-step logits within 1e-4, greedy
   streams identical and every kernel of the layout's path launched
   layers x its programs on the card; through the pool with the prefix
   cache off and on, lazy growth on a pool below demand and
   ``Priority()``, on the mixed and the split path: streams identical to
   the CPU's and to prefix off, every prefix, preemption and CoW counter
   equal to the CPU's, at least one preemption and one copy-on-write in
   the lazy runs; through the mixed step with speculative decode (k 4,
   the ngram drafter) on repetitive prompts: streams identical to the
   CPU's and to spec off, drafted and accepted counts equal to the CPU's
   and above 0; through the split-path engine on
   ``mamba2-smoke``,
   first-prefill logits within 1e-4 and greedy streams identical, the
   SSD kernel launched layers x prefills times on the card; through the
   split-path engine on ``zamba2-smoke``, a 3-layer ``rest > 0`` variant
   and a ``sliding_window=16`` variant, first-prefill logits within 1e-4,
   streams identical and the SSD kernel, flash and the fused MLP launched
   as the path says; through the train step (dense, ``mamba2-smoke`` and
   ``zamba2-smoke``, remat on), loss and gradients within 1e-4; then
   ``olmoe-smoke`` at capacity factor 2.0 (no-drop routing) on the mixed
   step, the split path on the pool and the dense layout: first-step
   logits within 1e-4, streams identical, paged attention, flash and the
   fused MLP (never) launched as the path says; and its train step: loss,
   aux loss and gradients within 1e-4; then ``whisper-smoke`` on the same
   three layouts (each request with its own frames): first-step logits
   within 1e-4, streams identical, paged attention, flash (the encoder at
   each admission, and the decoder in each split prefill) and the fused
   MLP (never) launched as the path says, one encode shape on the mixed
   step; and its train step with remat and 2 microbatches: losses and
   gradients within 1e-4; then ``llama-vision-smoke`` (rest 0) and a
   ``rest > 0`` variant with both gates open on the split path over dense
   rows (each request with its own images): first-prefill logits within
   1e-4, streams identical, flash once a self layer a prefill and the
   fused MLP once a layer a program; and each one's train step (remat, 2
   microbatches): loss and gradients within 1e-4; then the tiny dense
   config served tensor-parallel by two rank processes sharing the card
   over gloo (``launch/ranks.py``; ``ServeEngine(mesh=)``, one K/V head
   a rank) on the mixed step and the split path: both ranks' streams
   identical to the unsharded engine's on the card, ``decode_traces`` 1,
   the KV bytes a rank exactly half, every kernel launched on each rank
   as its path says, one all-reduce after ``wo`` and one after ``w_down``
   a layer a program, and the same two ranks serving the mixed step
   online (``AsyncDriver`` on each rank, rank 0 submitting before the
   start): rank 0's streams identical to the lockstep streams, launches
   as the path says on each rank; then the reference tests' tiny MoE (E 4, capacity
   factor 2.0: two experts a rank) and enc-dec configs served the same
   way on both paths: streams identical to the unsharded engine's on the
   card, the KV a rank half, launches as the path says, one ``moe_out``
   all-reduce a layer a program (MoE), two a layer of each encoder run
   and three a decoder layer a program (enc-dec); the MoE again with TP
   inside each expert (``Strategy(expert_parallel=False)``: every expert
   at half its d_ff a rank), the same checks and its ``moe_out`` bytes
   half the expert-parallel run's (1/k, k = 2) on the same programs; the
   tiny SSM config and
   a tiny hybrid (one group, one trailing layer) on the split path, a
   Mamba2 block of H / 2 whole heads a rank: streams identical, launches
   as the path says, the SSM states a rank half, one ``ssm_out`` and one
   ``ssm_norm`` sum a Mamba layer a program; the enc-dec config with one
   K/V head on the split path's dense rows, each rank's decoder K/V and
   cross K/V its slice of the positions with the head (the reference's
   ``cache_pspecs``): streams identical, the K/V a rank half, every
   decode step context-parallel in its self- and cross-attention; then
   data parallelism
   on the tiny dense config: a dp 2 ``ReplicaRouter`` in this process,
   both replicas on cuda:0 sharing one set of weights, on both paths
   (streams identical to the single engine's, both replicas prefill,
   launches summed over the replicas), and dp 2 x tp 2 over four rank
   processes sharing the card over gloo (every rank's union of streams
   equal to the single engine's, one program shape a replica, half the
   KV a rank, two disjoint rows of two ranks), and the same router
   online on the four ranks (rank 0's streams, row 1's requests'
   tokens returned by row 1's root, equal to the single engine's, each
   request on the lockstep router's replica), and the tiny SSM config's
   dp 2 x tp 2 router on the same ranks (streams equal to its single
   engine's, both replicas serving); then the context-parallel
   decode on two gloo ranks on the card: the Qwen3 smoke config with
   ``cp_decode`` at tp 2 (B 4, 16 of 32 positions a rank) after prompts
   of 28 and 14, four CP decode steps each, logits within the
   reference's 5e-4 of the unsharded decode on the card and a version
   that drops rank 0's (l, o) partial failing that check; and the Hkv-1
   dense config on dense rows, each rank its sequence slice of every
   row: streams equal to the unsharded engine's, the KV a rank half,
   launches as the path says, one head-assembly sum, one MAX and one SUM
   a layer a decode step;
5. the SERVING PATH: ``Session(get_config("qwen3-14b").with_(
   num_layers=16), device="cuda").serve(slots=4, max_len=1024,
   page_size=16, chunk_tokens=256)`` at full width, depth cut to 16 of
   its 40 layers (``MAIN_LAYERS``, the script's time limit; phases 5-10
   and 20 on these weights), with random weights from ``--seed``, 6 requests of 24-700 prompt
   tokens and 16 new tokens each. Launch counts are zeroed just before and
   read just after: paged attention and the fused MLP must each have run
   ``layers x program runs`` times. Prints tokens/s, step p50 and peak
   memory; then one more pair of requests runs under ``torch.profiler``
   for the device-time breakdown;
5b. the SPLIT SERVING PATH on phase 5's weights (its pool freed first):
   phase 5's six prompts, 16 new tokens each, through
   ``session.serve(paged=False, mixed=False)`` and
   ``session.serve(mixed=False)`` (4 slots x 1024 tokens), then one
   ``session.generate`` of a (4, 512) prompt for 16 steps. Counts are
   zeroed just before and read just after each: flash attention must have
   run ``layers x prefills`` times, the fused MLP ``layers x (prefills +
   decode steps)`` (``layers x 16`` for generate), paged attention
   ``layers x decode steps`` on the pool and never on the dense layout;
   every request must finish with 16 in-vocab tokens. Prints tokens/s,
   step p50 (steps with prefills and decode-only steps apart), peak
   memory, and the share of tokens equal to phase 5's streams (reported,
   not checked: in bf16 the two paths round differently); then one more
   pair of requests on each layout runs under ``torch.profiler``, its
   admission step and its decode-only steps apart;
6. the TRAIN PATH: the serving session is freed, then
   ``Session(qwen3-14b with num_layers=4, device="cuda").train(
   TrainConfig(steps=6, lr=3e-4), global_batch=1, seq_len=4096)`` with
   the default Strategy (AdamW, remat on, ``attn_impl="auto"``) at full
   width; depth is the one cut. Counts are zeroed just before and read
   just after: flash attention must have run ``layers x steps x 2``
   times (each layer's forward and its remat recompute), the fused MLP
   never (training takes the plain SwiGLU). Every loss and grad norm
   must be finite and the peak memory under the card's. Prints step p50,
   tokens/s, peak memory and the model-FLOPs share of 989 TFLOP/s;
7. the SSM SERVING PATH, after the trainer is freed:
   ``Session(family_config("mamba2-780m"), device="cuda").serve(slots=4,
   max_len=2048)`` at full width (24 of its 48 layers, ``FAMILY_LAYERS``:
   the script's time limit; bf16, random weights from
   ``--seed``) through the split path: 6 requests of 1024, 640, 384,
   256, 128 and 77 prompt tokens (each <= 128 or a multiple of 128, the
   reference's chunk precondition), 32 new tokens each. Launch counts are
   zeroed just before and read just after: ``ssd_scan`` must have run
   exactly ``48 x prefills`` times and the three other kernels never;
   every request must finish with 32 tokens, ``prefill_traces`` equal
   the 6 distinct lengths and ``decode_traces`` 1. Prints tokens/s, step
   p50 (steps with a prefill and decode-only steps), peak memory; then
   one more pair of requests (512 and 77 tokens, 12 new each) runs under
   ``torch.profiler``, its admission step and its decode-only steps in
   two windows, for the device time by kernel group, the device ops a
   step and the idle share of each kind of step.

8. PREFIX SHARING, LAZY GROWTH, COPY-ON-WRITE AND PREEMPTION on phase
   5's session (run after phase 5b): 8 requests on one 512-token system
   prompt (suffixes of 37-199 tokens; request 7 repeats request 2 and
   arrives once request 2 has 8 tokens), 32 new tokens each, through the
   mixed step without and with the prefix cache, with prefix cache and
   lazy growth on a 56-page pool, and the split path on that pool. Runs B
   and C must give run A's bf16 streams token for token; B takes >= 224
   blocks from the cache at a lower page peak, C preempts and copies on
   write at least once and returns every page once the cache is
   released; exact launch counts in every run; run D's share of tokens
   equal to A's is reported. Prints tokens/s, step p50, peak memory and
   the counters of each run.
9. SPECULATIVE DECODE on phase 5's session (after phase 8): 8 requests
   (4 prompts of 3-6-token motifs tiled to 200-600 tokens, 4 random
   prompts of 24-700 tokens), 32 new tokens each, through the mixed step
   without speculation (A), with the ngram drafter, k 4 (B), as B with
   the prefix cache and lazy growth on a 56-page pool (C), and with the
   verifier's own config and weights as the draft model on 2 slots (D:
   the first 2 requests, 16 new tokens). Runs B, C and D must give run
   A's bf16 streams token for token (B with A's program shapes), B must
   accept drafts and emit more than one token per (decode step, slot), C
   must leave no page in use once its prefix cache is released; exact
   launch counts in every run (D's draft forwards run flash and the fused
   MLP once a layer a draft token). Prints tokens/s, steps, step p50,
   accept rate, tokens per (decode step, slot), rollbacks, preemptions
   and peak pages of each run.
10. ONLINE SERVING on phase 5's session with run B's settings:
   ``Session.serve_async(start=False)`` with all 8 requests submitted,
   then started (streams must equal run B's); then
   ``Session.serve_http(port=0)`` with the 8 prompts POSTed to
   /generate from 8 client threads (one streaming), then /metrics and
   /healthz: every response carries its 32 tokens, the TTFT count is 8
   and /metrics' ``spec_drafted`` is the engine's; exact launch counts.
   Prints TTFT and TPOT p50/p90 and the share of tokens equal to run B's
   (reported, not checked).
11. HYBRID SERVING, after phase 7's session is freed:
   ``Session(family_config("zamba2-1.2b"), device="cuda").serve(slots=4,
   max_len=2048)`` at full width (20 of its 38 layers, ``FAMILY_LAYERS``:
   3 groups of 6 Mamba layers, each followed by the one shared attention
   + MLP block, and 2 trailing Mamba layers, as its 6 groups and 2; bf16, random weights from ``--seed``) through the split
   path: 6 requests of 1024, 640, 384, 256, 128 and 77 prompt tokens, 32
   new tokens each. Counts are zeroed just before and read just after:
   ``ssd_scan`` must have run 20 x prefills times, ``flash_attention`` 3
   x prefills, ``fused_mlp`` 3 x (prefills + decode steps), paged
   attention never; every request finishes with 32 in-vocab tokens,
   ``prefill_traces`` equals the 6 distinct lengths and ``decode_traces``
   1. Prints tokens/s, step p50 (with a prefill, decode only), peak
   memory and the decode state's bytes; one more pair under
   torch.profiler (admission step, decode-only steps, by kernel group);
   then ``Session.generate`` of a (4, 512) prompt for 16 steps (exact
   launch counts).
12. SSM AND HYBRID TRAINING at phase 7's and 11's depth: phase 6's run
   (AdamW, remat on, 1 x 4096 tokens, 3 steps (6 until phases 32-33: the
   script's time limit); seq_len 2048 only on out-of-memory, said in the
   record) on Mamba2-780M (24 of 48 layers) and on Zamba2-1.2B (20 of
   38). Flash attention must have run 0 times for Mamba2 and 3 groups x steps
   x 2 (forward and remat recompute) for the hybrid, the other kernels
   never (training takes the plain SSD scan and SwiGLU). Prints step p50,
   tokens/s, peak memory, the model-FLOPs share of 989 TFLOP/s (6
   N_applied tokens + the causal attention forward and backward + the SSD
   products forward and backward) and the profile by part.
13. MoE SERVING, after phase 12: ``Session(get_config("olmoe-1b-7b"),
   device="cuda").serve(slots=4, max_len=1024, page_size=16,
   chunk_tokens=256)`` uncut (16 layers, 64 experts top 8, bf16, random
   weights from ``--seed``, 6.92 B params) on phase 5's six prompt
   lengths (tokens in OLMoE's vocabulary), 16 new tokens each. Counts
   are zeroed just before and read just after: paged attention exactly
   16 x program runs, flash, the fused MLP and the SSD scan never; every
   request finishes with 16 in-vocab tokens; ``decode_traces`` within the
   (chunk, page bucket) pairs. Prints tokens/s, step p50 (steps with
   prefill rows and decode-only steps apart), peak memory and peak
   pages; one more pair of requests (600 and 40 tokens) runs under
   torch.profiler: device time of paged attention, routing and dispatch,
   the expert products and the combine (by ``models/moe.py``'s profiler
   ranges), the other GEMMs and the rest, and the idle share.
13b. the same session's split path on the pool (``serve(mixed=False)``)
   on the same requests: flash 16 x prefills, paged attention 16 x
   decode steps, the fused MLP never, ``prefill_traces`` the number of
   distinct prompt lengths (no bucket), each length one phase 3 held;
   the share of tokens equal to phase 13's streams is printed, not
   checked (in bf16 capacity couples rows differently on the two paths);
   the admission step and the decode-only steps of one more pair under
   the profiler apart.
14. MoE TRAINING: phase 6's run (AdamW, remat, 1 x 4096 tokens, 6 steps)
   on OLMoE-1B-7B at full width cut to 4 layers (~1.88 B params; the 16
   layers would need ~110 GB of weights, gradients and AdamW state):
   flash 4 x 6 x 2, the fused MLP never; loss, aux loss and grad norm
   finite. Prints step p50, tokens/s, peak memory, the profile by part
   and the model-FLOPs share of 989 TFLOP/s (``train_flops``: the
   experts at k / E of their parameters, the router in full, and the
   causal attention).

15. AUDIO SERVING, after phase 14: ``Session(get_config("whisper-tiny"),
   device="cuda").serve(slots=8, max_len=448, page_size=16,
   chunk_tokens=256)`` uncut (4 encoder and 4 decoder layers, d 384, 6/6
   heads x 64, vocab 51865, 1500 frames; bf16, random weights from
   ``--seed``, 56.36 M params) on 8 requests of 4-224 prompt tokens, each
   with its own (1500, 384) float32 frames from ``--seed``, 64 new tokens
   each (batch transcription with a decoder prompt). Counts are zeroed
   just before and read just after: paged attention exactly 4 x program
   runs, flash exactly 4 x admissions (the encoder, its own program), the
   fused MLP and the SSD scan never; ``encode_traces`` 1;
   ``decode_traces`` within the (chunk, page bucket) pairs; every request
   finishes with 64 in-vocab tokens. Prints tokens/s, step p50 (steps
   with prefill rows and decode-only steps apart), the encode program's
   device time a request, peak memory, peak pages and the resident
   decode state's bytes; one more pair (200 and 20 tokens) runs under
   torch.profiler: encoder flash, paged attention, cross-attention (by
   ``models/encdec.py::CROSS_RANGE``), other GEMMs, elementwise, and the
   idle share.
15b. the same session's split path on the pool (``serve(mixed=False)``)
   on the same requests: flash 8 x prefills (4 encoder and 4 decoder
   layers), paged attention 4 x decode steps, the fused MLP never,
   ``prefill_traces`` the number of distinct prompt lengths (no bucket),
   each length one phase 3 held; the share of tokens equal to phase 15's
   streams is printed, not checked (bf16 rounds differently on the two
   paths).
16. AUDIO TRAINING: whisper-tiny uncut, AdamW, remat, 6 steps on a
   ``data=`` object yielding 8 x 448 tokens and 8 x 1500 x 384 frames
   from ``--seed`` (``launch/train.py::FramesData``): flash 6 x (4
   encoder + 4 decoder + 4 decoder recompute), the fused MLP never; loss
   and grad norm finite. Prints step p50, tokens/s, peak memory, the
   profile by part and the model-FLOPs share of 989 TFLOP/s
   (``encdec_train_flops``).
17. VLM SERVING, after phase 16: ``Session(get_config(
   "llama-3.2-vision-90b").with_(num_layers=20), device="cuda").serve(
   slots=4, max_len=1024)`` at full width cut to 4 of its 20 groups (16
   self and 4 cross layers, and the unused trailing layer: ~20.07 B
   params, bf16, random weights from ``--seed`` with ``wo`` and
   ``w_down`` at the uncut model's init scale, both gates of every cross
   layer at 1.0) on the split path over dense rows, phase 5's six prompts
   each with its own (1601, 8192) float32 images, 16 new tokens each.
   Counts zeroed just before and read just after: flash exactly 16 x
   prefills, the fused MLP 20 x (prefills + decode steps), paged
   attention and the SSD scan never; ``prefill_traces`` the distinct
   prompt lengths, ``decode_traces`` 1; the decode state is ``kv_g`` +
   ``kv_t`` + ``xkv``. Prints tokens/s, the decode-only step p50 beside
   the floor of reading its weights at 3.35 TB/s, each prefill's time,
   peak memory, and one admission step and one decode-only step under
   torch.profiler by group (flash, fused MLP, the cross-attention range,
   other GEMMs, the rest) with the idle share.
18. VLM TRAINING: Llama-3.2-Vision-90B at full width cut to one group
   (``num_layers=5``: 4 self and 1 cross layer, ~7.24 B params), remat,
   Adafactor, 6 steps on ``launch/train.py::ImagesData`` (1 x 4096 tokens,
   2048 if 4096 does not fit, and 1 x 1601 x 8192 images from
   ``--seed``): flash 6 x (4 forward + 4 recompute), the fused MLP never;
   loss and grad norm finite. Prints step p50, tokens/s, peak memory, the
   profile by part and the model-FLOPs share of 989 TFLOP/s
   (``vlm_train_flops``).

19. TENSOR-PARALLEL SERVING, after phase 10's session is freed (run
   before phase 6): Qwen3-14B at full width, depth cut to 5 of its 40
   layers (the script's time limit: 20 since phases 30-31, 10 since
   phases 32-33, 5 since then), tp 2 over two rank processes sharing the
   one card over
   gloo, each through ``Session.serve(tp=2)`` and drawing only its
   shards (20/4 heads x 128 and d_ff 8704 of every layer, half the
   vocabulary):
   phase 5's settings and six prompts on the mixed step, then the split
   path on the same shards. Counts zeroed just before and read just
   after, on each rank: paged attention and the fused MLP 5 x program
   runs on the mixed step; flash 5 x prefills, the fused MLP 5 x
   programs and paged attention 5 x decode steps on the split path;
   every request finishes with 16 in-vocab tokens, both ranks' streams
   equal, the KV bytes a rank half of phase 5's pool's share of 5
   layers. Prints tokens/s, steps, step p50, each rank's peak memory and
   the collectives a rank. Two
   ranks share one card's SMs and gloo stages every all-reduce through
   host memory: these numbers are not tensor parallelism's speed. A
   rank's failure or timeout (``TP_TIMEOUT_S``) fails the run.
20. DATA-PARALLEL SERVING on phase 10's session (after phase 10, before
   it is freed): a dp 2 ``ReplicaRouter`` (``Session.serve(dp=2,
   devices=["cuda:0"] * 2)``), both replicas on the one card sharing its
   weights (29.5 GB uncut), each with its own pool of 4 slots x 1024 tokens;
   phase 5's six prompts (16 new tokens), then phase 8's shared-prompt
   traffic with the prefix cache (32 new tokens; request 7 arrives once
   request 2 has 8 tokens). Counts zeroed just before and read just
   after: paged attention and the fused MLP 16 x the replicas' program
   runs; every request finishes; both replicas prefill phase 5's
   traffic; each replica within its (chunk, page bucket) pairs; a
   request whose first block a replica took goes there while that
   replica is within ``slots`` of the least loaded; the streams equal
   phase 5's and phase 8's bit for bit. Prints tokens/s, the round
   p50, each replica's prefix hits and peak pages and the peak memory
   (one host thread steps both replicas: not data parallelism's speed).
21. MoE TENSOR-PARALLEL SERVING, after phase 13b: OLMoE-1B-7B uncut at
   tp 2 over two rank processes sharing the card over gloo, each through
   ``Session.serve(tp=2)`` drawing only its shards (8/8 heads x 128, 32
   of 64 experts a layer, half the vocabulary, ~6.9 GB); phase 13's
   settings and prompts on the mixed step, then the split path on the
   same shards. Counts zeroed just before and read just after on each
   rank: paged attention 16 x program runs on the mixed step, flash 16 x
   prefills and paged attention 16 x decode steps on the split path, the
   fused MLP never; every request finishes, both ranks' streams equal,
   the KV a rank half of phase 13's. Prints tokens/s, step p50, peak
   memory, the collectives a rank and the share of tokens equal to phase
   13's streams (reported, not checked: bf16 sums the attention
   partials in another order).
22. AUDIO TENSOR-PARALLEL SERVING, after phase 15b: whisper-tiny uncut at
   tp 2 (3/3 heads x 64 a rank; the odd 51,865-token vocabulary whole on
   both) over two rank processes on the card over gloo, phase 15's
   settings and requests (8 slots x 448, frames, 64 new tokens), the
   mixed step then the split path: launches as ``_audio_want`` says on
   each rank, both ranks' streams equal, the KV and cross blocks a rank
   half of phase 15's; the share of tokens equal to phase 15's reported.
23. CONTEXT-PARALLEL DECODE, after phase 19: Qwen3-14B at full width,
   depth cut to 5 of its 40 layers (the script's time limit: 20 since
   phases 30-31, 10 since phases 32-33, 5 since then), with
   ``cp_decode`` at tp 2, two
   rank processes on the card over gloo, each drawing only its shards:
   ``greedy_generate`` under the rank on one 8,192-token prompt for 32
   new tokens (8,224 positions, 4,112 a rank with all 8 K/V heads; every
   decode step context-parallel), then the head-sharded path on the same
   shards. Launches counted from 0 just before each and read just after:
   flash 5, the fused MLP 5 x 32, the others never; both ranks' streams
   equal; one ``cp_qkv``, ``cp_max`` and ``cp_sum`` a layer a CP decode
   step. Prints prefill seconds, decode step p50, a decode step's
   collectives and bytes by label, KV bytes and peak memory a rank and
   the share of tokens equal between the paths (information). Then the
   f32 check (TF32 off) at 2 layers, full width: 8 teacher-forced decode
   steps after a 1,024-token prompt, the CP logits within 1e-4 x the
   head-sharded logits' largest magnitude of the head-sharded path's, a
   version dropping rank 0's partial outside it. Not context
   parallelism's speed: two ranks share one card over gloo.
24. SHARDED TRAINING, after phase 6: Qwen3-14B at full width cut to 2
   layers at dp 2 x tp 2, four rank processes sharing the card over gloo,
   each through ``Trainer(mesh=)`` drawing only its shards (20/4 heads,
   d_ff 8704, half the vocabulary a rank; 1.108 B params): 1 AdamW step
   (remat on; 3 until phases 32-33, the time limit), a fresh global
   batch of 2 x 2048 tokens each step (the token dataset), under ZeRO-1
   (the default), FSDP and sequence parallelism. Counts zeroed just
   before each run and read just after, on each rank: flash 2 layers x 2
   (forward and remat recompute) a step, the others never. Every
   rank's loss and grad norm equal each step, the two data replicas'
   param blocks equal bit for bit after each step. Prints step p50,
   tokens/s, peak memory a rank and a step's collectives and bytes by
   label. Then the f32 check (TF32 off) at 1 layer, full width, 2 x 256
   tokens, lr 1e-3: the one-device step made in this process before the
   ranks start, its new params written to ``chip_tmp/`` (each rank reads
   its blocks by memory map), then each run at (2, 2): loss within 1e-4
   and
   every param within atol / rtol 5e-4 of it, and a version that drops
   the "data" gradient sum outside that bound. Four ranks share one
   card's SMs and gloo stages every collective through host memory: not
   parallelism's speed.
25. THE GPIPE PIPELINE, on phase 24's four rank processes: Qwen3-14B at
   full width cut to 8 layers, 2 a stage, over a (1, 4, 1) ("data",
   "pipe", "model") mesh (``make_pipeline_mesh``); the reference's
   ``pipeline_apply`` with the port's ``transformer.block`` as the stage
   function on M = 1, 4 and 8 microbatches of 1 x 2048 seeded hidden
   states: a ``no_grad`` forward and a forward + backward of ``(y **
   2).mean()`` (each block rematerialised), 2 times each (3 until the
   phases on rank processes shared them). Counts zeroed
   just before each run and read just after, on each rank: flash 2 (M +
   3) without a gradient and 4 (M + 3) with one (the recompute), the
   fused MLP 2 (M + 3) without a gradient and 0 with one, the others
   never; M + 3 stage
   moves, M + 2 backward moves, one output copy. Every rank's output
   equal bit for bit to the first rank's in every repeat and to the
   first rank's one-device run of the 8 layers per microbatch. Prints
   step p50 by M, ms a microbatch against that one-device run beside
   the simulator's (M + P - 1) / M, moves and bytes by label and peak
   memory a rank. Then the f32 check (TF32 off) at 1 layer a stage, 4 x
   256 tokens: output within atol / rtol 1e-5 and each stage gradient
   within atol 1e-5 of the tensor's largest value + rtol 1e-4 of each
   rank's own one-device run, and a broken backward ring outside that.
   Not pipeline parallelism's speed: four ranks share one card over
   gloo.
26. ONLINE TENSOR-PARALLEL SERVING, on phase 19's two rank processes
   after its split run, on the same rank shards (no new weights):
   Qwen3-14B at tp 2 through ``Session.serve_async(tp=2, start=False,
   watchdog_timeout=120)`` on every rank (phase 5's settings), phase
   19's six prompts submitted on rank 0 (16 new tokens each), then
   started on both (run A): rank 0's streams equal to phase 19's mixed
   lockstep streams bit for bit, launches as ``_want_launches`` says on
   each rank, ``decode_traces`` within phase 19's bound; then
   ``Session.serve_http(tp=2, port=0)`` on both ranks, rank 0 POSTing
   the six prompts to ``/generate`` from one client thread each (one
   chunked) while the loop runs, then ``GET /metrics`` and ``/healthz``
   (run B): every response 16 tokens, ``serve_ttft_seconds_count`` 6,
   the follower's engine counters equal to rank 0's. Prints tokens/s,
   step p50, TTFT and TPOT p50 / p90, the control channel's broadcasts,
   bytes and ms a pass, each rank's peak memory, and run B's share of
   tokens equal to phase 19's (reported: arrival order changes the
   batches). Two ranks share one card over gloo: not tensor
   parallelism's speed.

27. THE SSM FAMILY AND THE HYBRID AT TP 2, after phase 11: Mamba2-780M
   and Zamba2-1.2B at phase 7's and 11's depth (24 of 48 and 20 of 38
   layers), two rank processes on the
   card over gloo, each drawing only its shards (a Mamba2 block of H / 2
   whole heads: ``in_proj`` and the conv by head with all of B and C;
   Zamba2's shared block at 16/16 heads, d_ff 4096), phase 7's / 11's
   six prompts through ``Session.serve(tp=2)`` on the split path: 16 new
   tokens in bf16 (32 until phases 32-33), then 8 in f32 (TF32 off),
   whose streams must equal
   the one-device f32 engine's (run first in this process). Counts zeroed
   just before each run and read just after, on each rank: the SSD scan
   layers x prefills (Zamba2 also flash 6 x prefills and the fused MLP 6
   x programs), paged attention never. Both ranks' streams equal; one
   ``ssm_out`` and one ``ssm_norm`` sum a Mamba layer a program (Zamba2:
   one ``attn_out`` and one ``mlp_out`` an application), the embedding,
   logits and tokens, nothing else but the clock and the step check; a
   rank's SSM states half of the one-device engine's. Prints tokens/s,
   step p50, bytes a rank, collectives a program by label and the bf16
   share of tokens equal to phase 7's / 11's (information). Not tensor
   parallelism's speed: two ranks share one card over gloo. Phase 27 (and
   30 on its ranks) runs after phase 18.
28. SHARDED TRAINING OF THE SSM FAMILY, on phase 24's four rank
   processes after phase 25: Mamba2-780M at full width, depth cut to 12
   of its 48 layers (the script's time limit: 48 layers took 93.5 s, 24
   until phases 30-31 joined), at
   dp 2 x tp 2, phase 24's three runs (ZeRO-1, FSDP, SP) of
   1 AdamW step on 2 x 2048 tokens and its checks (no kernel runs: the
   SSM family trains through the plain SSD scan), then the f32 check at
   2 layers, full width: loss within 1e-4 and every param within atol /
   rtol 5e-4 of the one-device step's, and two defects outside that
   bound (the "data" gradient sum dropped; the gated norm's sum over
   "model" without its backward sum).
29. SHARDED TRAINING OF THE ENC-DEC FAMILY, on phase 24's four rank
   processes after phase 28: whisper-tiny at full width, uncut (4
   encoder and 4 decoder layers, 3/3 heads x 64 a rank, the whole
   51,865-row head on every rank), at dp 2 x tp 2, phase 24's three runs
   (ZeRO-1, FSDP, SP: the encoder's 1500 frames and the decoder's 448
   tokens each split over "model") of 2 AdamW steps on 8 x 448 tokens
   and one (8, 1500, 384) frames block (``FramesData``) and its checks
   (flash 2 x (4 encoder + 4 decoder + 4 decoder recompute) a run a rank,
   the other kernels never), then the f32 check uncut on 2 x 448 tokens
   and their frames: loss within 1e-4 and every param within atol / rtol
   5e-4 of the one-device step's, and two defects outside that bound
   (the "data" gradient sum dropped; ``enc_out``'s backward "model" sum
   into each decoder layer's cross K/V dropped). Prints step p50,
   tokens/s, peak memory a rank, a step's collectives and bytes by label
   and the flash launches. Not parallelism's speed: four ranks share one
   card over gloo.
30. TENSOR-PARALLEL SERVING OF THE VLM, on phase 27's two rank processes
   after they free their models: Llama-3.2-Vision-90B at full width cut
   to phase 17's 20 layers (16 self and 4 cross, 20.07 B params), tp 2
   through ``Session.serve(tp=2)`` (each rank drawing only its shards:
   32/4 heads x 128 of every self and cross layer, d_ff 14336, half the
   vocabulary, ~20 GB), phase 17's weights' scales, open gates, six
   requests and images, 16 new tokens each on the split path. Counts
   zeroed just before and read just after, on each rank: flash 16 x
   prefills, the fused MLP 20 x programs; every request finishes with 16
   in-vocab tokens, both ranks' streams equal, one ``attn_out`` and one
   ``mlp_out`` sum a self and a cross layer a program (and the
   embedding, logits and tokens; nothing else but the clock and the step
   check). Prints tokens/s, step p50 with prefill and decode-only apart,
   collectives a program by label, peak memory a rank and the share of
   tokens equal to phase 17's (information). Then the f32 check (TF32
   off) at full width cut to ``cross_attn_every=1, num_layers=2`` (4.67
   B params): the one-device engine first (in this process, before the
   ranks start, then freed), then the ranks: streams equal and the first
   prefill's logits within 1e-3 of the one device's, and a run without
   the cross layer's ``attn_out`` sum outside that.
31. SHARDED TRAINING OF THE VLM, on phase 24's four rank processes after
   phase 29: Llama-3.2-Vision-90B at full width cut to one group (4 self
   and 1 cross layer, 7.235 B params), dp 2 x tp 2 under FSDP, sequence
   parallelism and remat with Adafactor, gates open, 1 step (the time
   limit) of 2 x 1024 tokens beside a (2, 1601, 8192) image block, phase
   24's checks (flash 4 + 4 recompute a rank, the other kernels
   never), then the f32
   check at ``cross_attn_every=1, num_layers=2`` on 2 x 256 tokens and
   their images: the one-device step (Adafactor) on each rank in turn
   (no rank holds another's reference), then the (2, 2) FSDP + SP step
   and a (1, 4) SP step of the same ranks: loss within 1e-4, every
   param within atol / rtol 5e-4 and the norms' and gates' gradients
   before clipping within atol 1e-6 + rtol 1e-3 of it; and three defects
   outside those bounds (at (2, 2) no "data" gradient sum; at (1, 4) no
   gate sum under SP, and the cross query's ``region_in`` without its
   ``enter``: there a step sends no weights through gloo). Prints step
   p50,
   tokens/s, peak memory a rank and a step's collectives and bytes by
   label. Not parallelism's speed: four ranks share one card over gloo.
32. TP INSIDE EACH EXPERT, SERVING, on phase 21's two rank processes
   after its runs free their engines: OLMoE-1B-7B uncut through
   ``Session(cfg, strategy=Strategy(expert_parallel=False)).serve(tp=2,
   chunk_tokens=256, slots=4, max_len=1024, page_size=16)`` (each rank
   drawing only its shards: 8/8 heads x 128, all 64 experts at 512 of
   their 1024 d_ff, half the vocabulary), phase 13's six requests on the
   mixed step, 16 new tokens each. Counts zeroed just before and read
   just after, on each rank: paged attention 16 x program runs, the
   others never; every request finishes, both ranks' streams equal, one
   ``moe_out`` and one ``attn_out`` sum a layer a program, the
   ``moe_out`` bytes a program 1/8 (1/k) of phase 21's (the gate-weighted
   (T, d) output against the (T k, d) slots), the weights a rank within
   1% of phase 21's. Prints tokens/s, step p50, peak memory a rank,
   collectives and bytes a program and the share of tokens equal to
   phase 13's and 21's streams (information). Then the f32 check (TF32
   off) at full width cut to 1 of 16 layers: the one-device engine first
   (in this process, before phase 21's ranks start, then freed), then the
   ranks: streams equal and the first request's last logits within 1e-3
   of the one device's, and a run without the ``moe_out`` sum outside
   that.
33. MoE TRAINING ON A MESH, on phase 24's four rank processes after
   phase 31: OLMoE-1B-7B at full width cut to 2 of 16 layers (1.05 B
   params), dp 2 x tp 2, AdamW with remat, 1 step of 2 x 2048 tokens
   (the token dataset) in each of two runs that differ in the MoE's
   layout alone: the experts over "model" (``ep zero1``, the default
   strategy) and TP inside each expert (``tie zero1``), with phase 24's
   checks (flash 2 layers x 2 (forward and remat recompute) a run a
   rank, the others never); then the f32 check at 1 layer, full
   width, on 2 x 256 tokens: the one-device step made once in this
   process before phase 24's ranks start (its params and the router's
   gradient before clipping kept on disk for the ranks), then TP inside
   each expert with SP at (2, 2): loss within 1e-4, every param within
   atol / rtol 5e-4 and the router's gradient within atol 1e-6 + rtol
   1e-3; and two defects outside those bounds (no ``moe_out`` sum; the
   gates without their ``enter``). Prints step p50, tokens/s, peak
   memory a rank, a step's collectives and bytes by label and the flash
   launches. Not parallelism's speed: four ranks share one card over
   gloo.

34. THE PLANNER'S PLANS, ONE DEVICE (``core/planner.py``, the H100
    entry): the one-chip plan for phase 5's model over one 256-token
    chunk, ``Session.from_plan`` on it with phase 5's weights set through
    the params setter (after phase 20), phase 5's settings and six
    requests: streams bit-equal to phase 5's, paged attention and the
    fused MLP once a layer a program; after phase 6, the three searches'
    one-chip plans for phase 6's model and 1 x 4096 shape (each dp1 tp1
    pp1 m1) and phase 6's run for two steps from the first (flash as
    phase 6 launches it; its strategy is phase 6's but for its name, so
    its losses and grad norms equal phase 6's first two bit for bit).
    Each plan's summary, estimated step and MFU beside the measured p50,
    its MFU by the cost model's own FLOPs, and their ratio.
35. THE PLANNER'S PLANS ON RANKS: the "dp" search's 2-chip plan for
    phase 19's model over one 256-token chunk (dp1 tp2 sp) on phase 19's
    two rank processes, ``Session.from_plan(...).serve()`` at its degrees
    on its own mesh (the engine serves the Megatron layout under
    ``seq_parallel``): bf16 streams equal to phase 19's mixed run's,
    launches as phase 19's; the "dp" search's 4-chip plan for phase 24's
    model and 2 x 2048 shape (dp2 tp2 sp) on phase 24's four rank
    processes, ``train()`` at its degrees for phase 24's one step: its
    strategy is phase 24's SP run's but for its name, so each rank's loss
    and grad norm equal that run's bit for bit, flash launched as there.
    A plan that is not the one named fails the run. Each estimate beside
    the measured step: ranks share one card over gloo, so the ratio
    describes that setup, not the cost model.
36. DRY-RUN AGAINST THE CARD (``Session.lower``, ``launch/{specs,
    roofline,dryrun}.py``): phase 5's session (16 layers) prefills one
    1024-token prompt and takes one decode step of four rows over a
    2048-position cache, and phase 6's session (4 layers, its trained
    weights) takes phase 6's 1 x 4096 step on a new AdamW state; each is
    first traced on meta as the card's branch, then run once for real
    under the same ``Counter``: FLOPs, bytes and each kernel's charged
    cost equal exactly; argument bytes equal to the real arguments'; the
    dry-run's temp + arguments within 5% of the card's peak over the step
    (``max_memory_allocated`` reset before it, less what was resident
    beyond the step's arguments); the measured step (CUDA events; the
    training step phase 6's p50) at or above the roofline's lower bound,
    the ratio printed. On the training step each check is shown to
    reject a defect (a counter without the kernels' cost, a spec without
    the optimizer state, a peak without the temp, a 16 x 16 mesh's
    globals taken as one chip's). Then ``lower_one("qwen3-14b",
    "train_4k")`` on the 16 x 16 mesh, run by ``launch/dryrun.py`` in a
    process of its own with no card visible, started after phase 2: its
    record and trace seconds.
37. THE VLM BEHIND THE DP x TP ROUTER, on phase 24's four rank
    processes after phase 35's training: Llama-3.2-Vision-90B at full
    width cut to one group (5 layers, 7.235 B params) through
    ``Session.serve(dp=2, tp=2)``, two replicas of two ranks (32/4 heads
    and d_ff 14336 a rank), phase 17's six requests with their images,
    8 new tokens each: every request finishes, both replicas serve, the
    same union of streams on every rank, flash and the fused MLP
    launched as ``_vlm_want`` says, one ``attn_out`` and ``mlp_out`` sum a
    layer a program. Prints tokens/s, decode p50, peak memory a rank and
    requests a replica. The f32 check at one self and one cross layer:
    every rank's union of streams and homes equal a dp 2 router's of the
    same replicas unsharded on one device.
38. SERVING ON A ("pod", "data", "model") MESH, on the same processes:
    phase 4's tiny f32 config behind the router on (2, 1, 2) and (1, 2,
    2), the union of the streams equal to the unsharded engine's on the
    card, each rank's row its (pod, data) coordinate; then Qwen3-14B at
    phase 19's 5 layers on (2, 1, 2), phase 19's shards, settings and
    prompts on the paged mixed step: every request finishes, paged
    attention and the fused MLP once a layer a program, and the union
    of the streams equal to phase 19's mixed streams bit for bit. Prints
    tokens/s, step p50 and the collectives by label.

Last, every process the run started (nvcc, cuobjdump, the rank
processes and the ``multiprocessing`` resource tracker their start
launched) must have ended and been reaped, or the run fails.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The full record also goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM rate and dense peaks by input type (the
# bf16 peak and the HBM rate are core/costmodel.py::H100's)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def child_processes() -> list:
    """(pid, state, command) of every process whose parent is this one,
    zombies included, from ``/proc``."""
    me, out = os.getpid(), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:                   # ended while we looked
            continue
        if int(ppid) == me:
            out.append((int(pid), state, cmd.strip()[:160]))
    return out


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(calls, iters: int = 10) -> float:
    """Mean device time of one of ``calls`` (functions of no argument),
    captured once into a CUDA graph and replayed ``iters`` times, by CUDA
    events: the kernels' time without the host's launch path, which
    ``time_ms`` includes where it is the slower side."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm up outside the capture
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * len(calls))


def worst_excess(a, want, atol: float, rtol: float) -> float:
    """The worst |a - want| / (atol + rtol |want|) over all values: <= 1
    passes the per-value limit."""
    a, want = a.float(), want.float()
    return ((a - want).abs() / (atol + rtol * want.abs())).max().item()


def bound_ms(work, dtype: str):
    """The least time the card could take for a kernel's ``work``, its
    module's ``cost(...)`` = (flops, bytes): the larger of the bytes over
    the HBM rate and the operations over the peak for their type, the
    rates ``core/costmodel.py::H100``'s (bf16; fp32 from the same data
    sheet)."""
    from repro_torch.core.costmodel import H100
    flops, nbytes = work
    peak = H100.peak_flops if dtype == "bfloat16" else PEAK_FLOPS[dtype]
    t_mem = nbytes / H100.hbm_bw * 1e3
    t_ops = flops / peak * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


# ---------------------------------------------------------------- phase 1-2

def phase_card():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    return smi


#: the tensor-core kernels: library -> substring of the kernel's symbol
TENSOR_CORE_KERNELS = {"flash_attention": "flash_fwd_wgmma_kernel",
                       "fused_mlp": "mlp_tma_wgmma_kernel",
                       "paged_attention": "paged_attn_wgmma_kernel"}


def sass_counts(build):
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in the SASS of
    each tensor-core kernel, by ``cuobjdump -sass`` (beside the ``nvcc``
    that built it) on its library; None where the toolkit has none."""
    exe = Path(build._nvcc()).with_name("cuobjdump")
    if not exe.exists():
        return None
    counts = {}
    for lib, symbol in TENSOR_CORE_KERNELS.items():
        text = subprocess.run([str(exe), "-sass", str(build._target(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for section in text.split("Function : ")[1:]:
            name = section.split(None, 1)[0]
            if symbol in name:
                counts[name] = {op: section.count(op)
                                for op in ("HGMMA", "UTMALDG")}
    return counts


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    dt = time.perf_counter() - t0
    log(f"[build] {len(build.SIGNATURES)} kernels "
        f"({', '.join(build.SIGNATURES)}) built and loaded in {dt:.1f}s")
    for name, text in build.PTXAS_LOG.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                log(f"[ptxas {name}] {line.strip()}")
    sass = sass_counts(build)
    if sass is None:
        log("[sass] cuobjdump not found: HGMMA / UTMALDG not counted")
    else:
        for symbol in TENSOR_CORE_KERNELS.values():
            check(any(symbol in n for n in sass),
                  f"no {symbol} in the SASS of its library")
        for name, c in sass.items():
            log(f"[sass] {name[:70]}: {c['HGMMA']} HGMMA, {c['UTMALDG']} "
                f"UTMALDG")
            check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
                  f"{name}: no wgmma or no TMA load in its SASS ({c})")
    return dt, sass


# ------------------------------------------------------------------ phase 3

#: the serving path's paged-attention mixes (Qwen3-14B heads, a 4-slot x
#: 1024-token pool of 16-token pages): tokens held per slot, and each row's
#: (slot, cursor)
SLOT_CTX = (716, 300, 520, 640)
MIX_T256 = ([0, 1, 2] + [3] * 253, [715, 299, 519] + list(range(256, 509)))
MIX_DECODE = ([0, 1, 2, 3] + [0] * 252, [715, 299, 519, 639] + [0] * 252)
#: the split path's decode (phase 5b): one row a slot; a retired slot's row
#: holds the null page
MIX_SPLIT = ([0, 1, 2, 3], [715, 299, 519, 639])
MIX_SPLIT_IDLE = ([0, 1, 2, 3], [715, 299, 519, 0])


def attention_inputs(rng, dtype, *, n_layers_copies=1, ctx=SLOT_CTX,
                     rows=MIX_T256, edit=None, width=64, n_pages=257,
                     heads=(40, 8), head_dim=128):
    """Paged-attention inputs on permuted, fragmented page tables of
    ``width`` pages over a pool of ``n_pages`` (257: 4 slots x 1024
    tokens): ``ctx`` tokens held per slot, ``rows`` (slots, cursors). The
    default is the main path's T = 256 mix: three decode rows at their
    slots' cursors and 253 rows of one slot's prefill chunk.
    ``edit(tables)`` may change the slot tables before the rows take
    them. ``heads``: (Hq, Hkv), Qwen3-14B's by default; D ``head_dim``,
    128 by default."""
    (hq, hkv), d, ps = heads, head_dim, 16
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((len(ctx), width), np.int32)
    k = 0
    for s, n in enumerate(ctx):
        blocks = -(-n // ps)
        tables[s, :blocks] = perm[k:k + blocks]
        k += blocks
    if edit is not None:
        edit(tables)
    rows_slot, rows_pos = rows
    tab = torch.from_numpy(tables[rows_slot]).cuda()
    pos = torch.tensor(rows_pos, dtype=torch.int32).cuda()
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    pools = [(torch.randn((n_pages, ps, hkv, d), generator=gen,
                          device="cuda").to(dtype),
              torch.randn((n_pages, ps, hkv, d), generator=gen,
                          device="cuda").to(dtype))
             for _ in range(n_layers_copies)]
    q = torch.randn((len(rows_slot), 1, hq, d), generator=gen,
                    device="cuda").to(dtype)
    # live tokens per slot: the longest cursor of any row of that slot
    live = {}
    for s, p in zip(rows_slot, rows_pos):
        live[s] = max(live.get(s, 0), p + 1)
    return q, pools, tab, pos, sum(live.values()), tables, rows_slot, live


def device_us(fn, calls: int = 5):
    """Mean device time of each kernel ``fn`` launches, in us, from
    torch.profiler over ``calls`` calls (empty if it records none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        name = re.search(r"\w+_kernel", e.key)
        if t:
            out[name.group(0) if name else e.key[:60]] = t / calls
    return out


#: kv lengths of the row-alone check: around the 256-key segment boundary
#: and past it, up to 16 segments
ROW_ALONE_KV = (255, 256, 257, 700, 1024, 4096)


def row_alone_check():
    """bf16, Qwen3-14B heads: one row (the same q, table row and kv_len)
    computed alone (split past 256 keys), first and last in a run of its
    slot's 1 + 4 rows, after a shorter row of a slot sharing its first
    pages and before a longer row of a slot sharing all its pages
    (``kernels/paged_attention.py::neighbour_mixes``) must give the same
    bits in every case; alone, within the per-value limit of the fp32-P
    plain version. Returns the cases checked a kv length."""
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    out = {}
    for kv_len in ROW_ALONE_KV:
        mixes, n_pages = pa.neighbour_mixes(kv_len, seed=kv_len)
        kp, vp, q0 = rnd(n_pages, 16, 8, 128), rnd(n_pages, 16, 8, 128), \
            rnd(40, 128)
        rows, worst = {}, 0.0
        for name, (tab, pos, r) in mixes.items():
            q = rnd(len(pos), 1, 40, 128)
            q[r, 0] = q0
            args = (q, kp, vp, torch.from_numpy(tab).cuda(),
                    torch.from_numpy(pos).cuda())
            got = pa.paged_attention(*args)
            rows[name] = got[r]
            if name == "alone":
                worst = worst_excess(got, pa.paged_attention_plain_f32p(
                    *args), 1e-5, 8e-3)
                items = pa.tile_plan(tab, pos, 16, 5)[0]
        torch.cuda.synchronize()
        differ = [name for name, o in rows.items()
                  if not torch.equal(o, rows["alone"])]
        check(not differ, f"paged attention bf16 at kv_len {kv_len}: the "
              f"row's bits differ from its lone run in {differ}")
        check(worst <= 1.0, f"paged attention bf16 lone row at kv_len "
              f"{kv_len}: {worst:.3f}x the per-value limit")
        log(f"[attention bf16 row alone] kv_len {kv_len}: {len(items)} "
            f"work item(s) alone; equal bits in all {len(rows)} cases "
            f"({', '.join(rows)}); alone {worst:.3f}x the per-value limit")
        out[kv_len] = {"cases": list(rows), "items_alone": len(items),
                       "error_of_limit": worst}
    return out


#: the bf16 paged-attention kernel's launches (csrc/paged_attention.cu)
PAGED_LAUNCHES = ("paged_plan_kernel", "paged_attn_wgmma_kernel",
                  "paged_combine_kernel")


def phase_attention(rng):
    from repro_torch.kernels import paged_attention as pa
    res = {}
    # bf16: the two round differently (the plain version casts the probs to
    # bf16 before P.V, the kernel keeps them fp32); 1e-2 is 2.5 bf16 ulps at
    # |out| in [0.5, 1). fp32 carries the check on the kernel's logic.
    tol = {"bfloat16": (1e-2, 0.0), "float32": (2e-5, 2e-5)}
    for dt_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dt_name)
        q, pools, tab, pos, live_tokens, tables, rows_slot, live = \
            attention_inputs(rng, dtype)
        kp, vp = pools[0]
        got = pa.paged_attention(q, kp, vp, tab, pos)
        want = pa.paged_attention_plain(q, kp, vp, tab, pos)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(bool(torch.isfinite(got).all()), "attention output finite")
        atol, rtol = tol[dt_name]
        check(torch.allclose(got.float(), want.float(), atol=atol,
                              rtol=rtol),
              f"paged attention {dt_name} kernel vs plain: max abs err "
              f"{err} > atol {atol}, rtol {rtol}")
        ref = want.float()
        log(f"[attention {dt_name}] kernel vs plain max_abs_err {err:.3e} "
            f"(atol {atol}, rtol {rtol}; reference rms "
            f"{ref.pow(2).mean().sqrt().item():.3e}, max "
            f"{ref.abs().max().item():.3e})")
        res[dt_name] = err
    # bf16 per value against the Pallas arithmetic (P fp32, V upcast): both
    # compute in fp32 from the same bf16 inputs and round the output once,
    # so a correct kernel is within one bf16 ulp of each value (the flash
    # rule); the same check must reject a kernel run with one live page of
    # the prefill slot replaced by the null page (read by 253 rows)
    atol, rtol = 1e-5, 8e-3

    def excess(a, w):                 # worst |a - w| / (atol + rtol |w|)
        return ((a.float() - w.float()).abs()
                / (atol + rtol * w.float().abs())).max().item()

    q, pools, tab, pos, _, tables, rows_slot, live = \
        attention_inputs(rng, torch.bfloat16)
    kp, vp = pools[0]
    got = pa.paged_attention(q, kp, vp, tab, pos)
    again = pa.paged_attention(q, kp, vp, tab, pos)
    want = pa.paged_attention_plain_f32p(q, kp, vp, tab, pos)
    per_value = excess(got, want)
    check(per_value <= 1.0, f"paged attention bf16 per value vs the fp32-P "
          f"plain version: worst error {per_value:.3f}x atol {atol} + rtol "
          f"{rtol}")
    check(torch.equal(got, again), "two identical paged-attention calls "
          "gave different bits")
    dropped = tab.clone()
    dropped[3:, 5] = 0                        # slot 3's 6th page: null page
    drop = excess(pa.paged_attention(q, kp, vp, dropped, pos), want)
    check(drop > 1.0, f"the per-value check passes a kernel run with a live "
          f"page dropped ({drop:.3f}x the limit)")
    log(f"[attention bf16 T=256] per value vs the fp32-P plain version: "
        f"worst error {per_value:.3f}x the limit (atol {atol}, rtol {rtol});"
        f" a dropped live page would be {drop:.1f}x the limit; two "
        f"identical calls give equal bits")
    res["bf16_worst_error_of_limit"] = per_value
    res["bf16_dropped_page_error_of_limit"] = drop

    # row structures the tiling must get right, each held per value to the
    # fp32-P plain version and at 1e-2 to the gather plain version, and its
    # device plan to kernels/paged_attention.py::tile_plan
    def first_pages_only(tables):             # slot 1 shares slot 0's first
        tables[1, :5] = tables[0, :5]         # 5 pages, then parts from it

    def idle_slot_3(tables):                  # a retired slot's table row
        tables[3] = 0

    cases = [
        ("a tile straddling two slots",
         dict(rows=([2] * 7 + [3] * 9, list(range(100, 107))
                    + list(range(200, 209))))),
        ("consecutive rows agreeing on their first pages only",
         dict(ctx=(716, 716), edit=first_pages_only,
              rows=([0, 1, 0, 1], [300, 400, 70, 400]))),
        ("a lone decode row of 1024 tokens (split)",
         dict(ctx=(1024,), rows=([0], [1023]))),
        ("the decode-only mix (4 decode rows, 252 pad rows of slot 0 at "
         "pos 0)", dict(rows=MIX_DECODE)),
        # phase 5b's paged split decode: one row a slot, no pad rows
        ("the split decode table (4 rows, one a slot)",
         dict(rows=MIX_SPLIT)),
        ("the split decode table with an idle slot (its row on the null "
         "page)", dict(edit=idle_slot_3, rows=MIX_SPLIT_IDLE)),
    ]
    res["cases"] = []
    for what, kw in cases:
        q, pools, tab, pos, *_ = attention_inputs(rng, torch.bfloat16, **kw)
        kp, vp = pools[0]
        got = pa.paged_attention(q, kp, vp, tab, pos)
        e_f32p = excess(got, pa.paged_attention_plain_f32p(q, kp, vp, tab,
                                                           pos))
        e_gather = (got.float() - pa.paged_attention_plain(
            q, kp, vp, tab, pos).float()).abs().max().item()
        items, splits = pa.device_tile_plan(tab, pos, 16, 5)
        want_items, want_splits = pa.tile_plan(tab.cpu().numpy(),
                                               pos.cpu().numpy(), 16, 5)
        check(bool(torch.isfinite(got).all()) and e_f32p <= 1.0
              and e_gather <= 1e-2,
              f"paged attention bf16, {what}: {e_f32p:.3f}x the per-value "
              f"limit, {e_gather:.3e} from the gather plain version")
        check(items == want_items and (splits == want_splits).all(),
              f"paged attention, {what}: device plan {items} != tile_plan "
              f"{want_items}")
        log(f"[attention bf16] {what}: per value {e_f32p:.3f}x the limit, "
            f"vs gather {e_gather:.3e} (atol 1e-2); {len(items)} work items "
            f"({sum(1 for it in items if it[2] >= 0)} splits), device plan "
            f"= tile_plan")
        res["cases"].append({"case": what, "error_of_limit": e_f32p,
                             "max_abs_err_gather": e_gather,
                             "items": len(items)})
    # the same limit rejects the split decode table run with one live page
    # of a lone (so split) row replaced by the null page
    q, pools, tab, pos, *_ = attention_inputs(rng, torch.bfloat16,
                                              rows=MIX_SPLIT)
    kp, vp = pools[0]
    dropped = tab.clone()
    dropped[2, 10] = 0                        # slot 2's 11th of 33 pages
    split_drop = excess(pa.paged_attention(q, kp, vp, dropped, pos),
                        pa.paged_attention_plain_f32p(q, kp, vp, tab, pos))
    check(split_drop > 1.0, f"the per-value check passes the split decode "
          f"table with a live page dropped ({split_drop:.3f}x the limit)")
    log(f"[attention bf16] the split decode table with a live page dropped "
        f"would be {split_drop:.1f}x the limit")
    res["split_dropped_page_error_of_limit"] = split_drop

    res["row_alone"] = row_alone_check()

    # null-page / tail poisoning (tests/test_serve_pallas.py:105): pages no
    # row references, page 0, and every slot's positions past its longest
    # cursor hold 1e9 — the kernel output must not change, bit for bit
    q, pools, tab, pos, _, tables, rows_slot, live = \
        attention_inputs(rng, torch.bfloat16)
    kp, vp = pools[0]
    clean = pa.paged_attention(q, kp, vp, tab, pos)
    used = set()
    for s, n in live.items():
        blocks = -(-n // 16)
        used.update(int(x) for x in tables[s, :blocks])
        last = int(tables[s, blocks - 1])
        kp[last, n - (blocks - 1) * 16:] = 1e9
        vp[last, n - (blocks - 1) * 16:] = 1e9
    poison = [p for p in range(kp.shape[0]) if p not in used]
    kp[poison] = 1e9
    vp[poison] = 1e9
    dirty = pa.paged_attention(q, kp, vp, tab, pos)
    check(torch.equal(clean, dirty), "poisoned null/unreferenced/tail "
          "pages changed the kernel output")
    log(f"[attention] poisoning {len(poison)} unreferenced pages and "
        f"{len(live)} slot tails: output bitwise unchanged")
    # times at the main path's bf16 mixes; 8 layer pools in rotation so the
    # pool (16.8 MB a layer) is not warm in the 50 MB L2
    from repro_torch.models.kvcache import gather_pages
    sdpa = torch.nn.functional.scaled_dot_product_attention
    d, hkv, hq, esize = 128, 8, 40, 2
    times = {}
    for name, kw in (("T256", dict(rows=MIX_T256)),
                     ("decode_only", dict(rows=MIX_DECODE)),
                     # four lone 4096-key decode rows: 16 segments each
                     ("decode_4x4096", dict(
                         ctx=(4096,) * 4, rows=([0, 1, 2, 3], [4095] * 4),
                         width=256, n_pages=1025))):
        # the long-decode mix draws from its own generator, so the later
        # phases see the inputs they saw before it was added
        q, pools, tab, pos, live_tokens, *_ = attention_inputs(
            np.random.default_rng(4096) if name == "decode_4x4096" else rng,
            torch.bfloat16, n_layers_copies=8, **kw)
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % len(pools)
            return pools[it["i"]]

        # the kernel's device time from graph replay; eager calls by CUDA
        # events also carry the wrapper's host path (three launches)
        kernel = graph_ms([lambda kv=kv: pa.paged_attention(q, *kv, tab, pos)
                           for kv in pools])
        eager = time_ms(lambda: pa.paged_attention(q, *nxt(), tab, pos))
        launches = device_us(lambda: pa.paged_attention(q, *nxt(), tab, pos))
        plain = time_ms(lambda: pa.paged_attention_plain(
            q, *nxt(), tab, pos), iters=3, warmup=1)
        # library yardstick: SDPA over the gathered, GQA-expanded KV with
        # the kv_len mask; the gather is done before the timed call
        kp, vp = pools[0]
        rep = hq // hkv
        kg = gather_pages(kp, tab).transpose(1, 2).repeat_interleave(rep, 1)
        vg = gather_pages(vp, tab).transpose(1, 2).repeat_interleave(rep, 1)
        mask = (torch.arange(kg.shape[2], device="cuda")[None, :]
                < (pos.long() + 1)[:, None])[:, None, None, :]
        qs = q.transpose(1, 2)
        library = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask))
        del kg, vg
        # unique live K and V, q in, out, the table and the cursors
        check(pa.live_tokens(tab.cpu().numpy(), pos.cpu().numpy(), 16)
              == live_tokens, f"{name}: live tokens")
        bms, by = bound_ms(pa.cost(tab.cpu().numpy(), pos.cpu().numpy(), hq,
                                   hkv, d, 16, esize=esize), "bfloat16")
        check(all(k in launches for k in PAGED_LAUNCHES) or not launches,
              f"paged attention launches {sorted(launches)} lack one of "
              f"{PAGED_LAUNCHES}")
        times[name] = {"ms": kernel, "eager_ms": eager, "plain_ms": plain,
                       "library_ms": library, "bound_ms": bms, "bound_by": by,
                       "device_us_by_launch": launches}
        log(f"[attention bf16 {name}] kernel {kernel:.4f} ms by graph "
            f"replay, {eager:.4f} ms a call eager (device: "
            + ", ".join(f"{k} {v:.1f} us" for k, v in launches.items())
            + f"), plain {plain:.4f} ms, sdpa {library:.4f} ms, bound "
            f"{bms:.4f} ms ({by}, {live_tokens} live tokens)")
    t256 = times["T256"]
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:99",
            "launch_kernels": list(PAGED_LAUNCHES),
            "max_abs_err": res["bfloat16"], "max_abs_err_f32": res["float32"],
            "tolerance": "bf16 atol 1e-2 rtol 0 vs the gather plain version "
                         "and atol 1e-5 + rtol 8e-3 of each value vs the "
                         "fp32-P plain version, fp32 atol=rtol=2e-5",
            "bf16_worst_error_of_limit": res["bf16_worst_error_of_limit"],
            "bf16_dropped_page_error_of_limit":
                res["bf16_dropped_page_error_of_limit"],
            "cases": res["cases"],
            "split_dropped_page_error_of_limit":
                res["split_dropped_page_error_of_limit"],
            "ms": t256["ms"], "kernel_ms": t256["ms"],
            "eager_ms": t256["eager_ms"],
            "plain_ms": t256["plain_ms"], "bound_ms": t256["bound_ms"],
            "bound_by": t256["bound_by"], "library_ms": t256["library_ms"],
            "device_us_by_launch": t256["device_us_by_launch"],
            "decode_only": times["decode_only"],
            "decode_4x4096": times["decode_4x4096"],
            "row_alone": res["row_alone"],
            "library": "scaled_dot_product_attention over gathered KV"}


#: the fused MLP's row counts on the split path (phase 5b) beside the
#: T = 256 of phase 5: a 4-slot decode, prefill buckets, generate's 4 x 512
MLP_SPLIT_ROWS = (4, 32, 64, 128, 512, 1024, 2048)
#: draws of x at each row count of the seed sweep
MLP_SWEEP_SEEDS = 16


def exact_h_mlp(x, wg64, wu64, wd64):
    """The SwiGLU with h from fp64 sums rounded once to bf16 and the down
    projection summed in fp64 and rounded once: the exactly rounded
    reference of a bf16 kernel that stores h in bf16."""
    x64 = x.double()
    h = (torch.nn.functional.silu(x64 @ wg64) * (x64 @ wu64)).to(
        torch.bfloat16)
    return (h.double() @ wd64).to(torch.bfloat16)


def mlp_seed_sweep(wg, wu, wd, atol: float, rtol: float,
                   row_counts=tuple(sorted(set(MLP_SPLIT_ROWS) | {256})),
                   seeds: int = MLP_SWEEP_SEEDS):
    """At each of ``row_counts`` (by default every row count of the split
    path and T = 256), draw x from ``seeds`` seeds and measure,
    as multiples of the per-value limit: (a) the kernel against the plain
    version, (b) the plain version against the exactly rounded h
    reference, (c) the kernel against that reference. Returns {T: {"a",
    "b", "c": worst over the seeds, "seeds_a_over": seeds where (a) >
    1}}."""
    from repro_torch.kernels import fused_mlp as fm
    wg64, wu64, wd64 = wg.double(), wu.double(), wd.double()
    d, f = wg.shape
    out = {}
    for rows in row_counts:
        worst = {"a": 0.0, "b": 0.0, "c": 0.0}
        over = []
        for seed in range(seeds):
            gen = torch.Generator(device="cuda").manual_seed(
                100_003 * rows + seed)
            x = torch.randn((rows, d), generator=gen, device="cuda").to(
                torch.bfloat16)
            got = fm.fused_mlp(x, wg, wu, wd)
            plain = fm.fused_mlp_plain(x, wg, wu, wd)
            exact = exact_h_mlp(x, wg64, wu64, wd64)
            e = {"a": worst_excess(got, plain, atol, rtol),
                 "b": worst_excess(plain, exact, atol, rtol),
                 "c": worst_excess(got, exact, atol, rtol)}
            if e["a"] > 1.0:
                over.append(seed)
            worst = {k: max(worst[k], e[k]) for k in worst}
        torch.cuda.synchronize()
        log(f"[mlp bf16 sweep T={rows} d={d} f={f}] worst of "
            f"{seeds} seeds, "
            f"x the limit (atol {atol}, rtol {rtol}): (a) kernel vs plain "
            f"{worst['a']:.3f}, (b) plain vs exact h {worst['b']:.3f}, (c) "
            f"kernel vs exact h {worst['c']:.3f}; seeds with (a) > 1: "
            f"{over}")
        out[rows] = {**worst, "seeds_a_over": over}
    del wg64, wu64, wd64
    return out


def _mlp_rows(gen, rows: int, wg, wu, wd, atol: float, rtol: float, *,
              timed: bool):
    """The bf16 fused MLP at ``rows`` rows of x against its plain version,
    per value, the check shown to reject a version with one 64-wide f tile
    of h dropped; ``timed``: kernel, plain version, three matmuls and the
    bound too. Returns the row count's record."""
    from repro_torch.kernels import fused_mlp as fm
    d, f = wg.shape
    x = torch.randn((rows, d), generator=gen, device="cuda").to(wg.dtype)
    want = fm.fused_mlp_plain(x, wg, wu, wd)
    got = fm.fused_mlp(x, wg, wu, wd)
    e = worst_excess(got, want, atol, rtol)
    wd_drop = wd.clone()
    wd_drop[f // 2:f // 2 + 64] = 0
    dr = worst_excess(fm.fused_mlp_plain(x, wg, wu, wd_drop), want, atol,
                      rtol)
    del wd_drop
    plan = fm.mlp_plan(rows, d, f, torch.cuda.get_device_properties(
        0).multi_processor_count)
    check(bool(torch.isfinite(got).all()) and e <= 1.0,
          f"fused MLP bf16 at T={rows} d={d} f={f} (plan {plan}): worst "
          f"error {e:.3f}x atol {atol} + rtol {rtol}")
    check(dr > 1.0, f"the bf16 check at T={rows} d={d} passes a dropped f "
                    f"tile ({dr:.3f}x the limit)")
    rec = {"t": rows, "d": d, "f": f, "plan": list(plan),
           "error_of_limit": e, "dropped_tile_error_of_limit": dr}
    msg = (f"[mlp bf16 T={rows} d={d} f={f}] plan {plan[:3]}: worst error "
           f"{e:.3f}x the limit (atol {atol}, rtol {rtol}); a dropped "
           f"64-wide f tile would be {dr:.1f}x")
    if timed:
        silu = torch.nn.functional.silu
        rec.update(_small_times(
            lambda: fm.fused_mlp(x, wg, wu, wd),
            lambda: torch.matmul(silu(torch.matmul(x, wg))
                                 * torch.matmul(x, wu), wd),
            lambda: fm.fused_mlp_plain(x, wg, wu, wd)))
        rec["bound_ms"], rec["bound_by"] = bound_ms(fm.cost(rows, d, f),
                                                    "bfloat16")
        msg += _small_times_text(rec, "3x matmul")
    log(msg)
    return rec


def phase_mlp(rng):
    from repro_torch.kernels import fused_mlp as fm
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    # fp32 at a ragged small shape (T, d, f not multiples of any tile)
    t, d, f = 37, 72, 100
    x = torch.randn((t, d), generator=gen, device="cuda")
    w = [torch.randn(s, generator=gen, device="cuda") * 0.05
         for s in ((d, f), (d, f), (f, d))]
    err32 = (fm.fused_mlp(x, *w) - fm.fused_mlp_plain(x, *w)).abs().max()
    err32 = err32.item()
    check(err32 <= 1e-5, f"fused MLP fp32 ragged: max abs err {err32} > 1e-5")
    log(f"[mlp f32 T={t} d={d} f={f}] kernel vs plain max_abs_err "
        f"{err32:.3e} (atol 1e-5)")
    # bf16 at the main path's shape, weights at the init scales. The limit
    # is per value, atol + rtol |want|: rtol 8e-3 is one bf16 ulp of the
    # output (both round it once); atol 1e-3 covers h's rounding flips.
    # Kernel and plain version sum x.Wg and x.Wu in other orders, so some
    # h values (up to |h| ~ 16, ulp 0.0625) round to the other neighbour,
    # each moving an output by ulp(h) |Wd| ~ 1e-4. The run prints the atol
    # the kernel needs and the atol a version with an exactly rounded h
    # (from fp64 sums) needs: the second is over 1e-4, so 1e-4 would fail
    # even an exact kernel. The same check rejects the two plain variants
    # below, and holds on 16 draws of x at every row count (the seed
    # sweep; before the kernel summed each stage's products from zero, its
    # h flipped 8x as often as the plain version's and the outputs reached
    # 1.14x the limit).
    t, d, f = 256, 5120, 17408
    atol, rtol = 1e-3, 8e-3
    bf = torch.bfloat16
    x = torch.randn((t, d), generator=gen, device="cuda").to(bf)
    wg = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wu = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wd = (torch.randn((f, d), generator=gen, device="cuda")
          * (0.02 / math.sqrt(80))).to(bf)
    got = fm.fused_mlp(x, wg, wu, wd).float()
    want = fm.fused_mlp_plain(x, wg, wu, wd).float()

    def excess(a):                    # worst |a - want| / (atol + rtol|want|)
        return ((a.float() - want).abs()
                / (atol + rtol * want.abs())).max().item()

    err, bf16_excess = (got - want).abs().max().item(), excess(got)
    check(bool(torch.isfinite(got).all()), "fused MLP output finite")
    check(bf16_excess <= 1.0, f"fused MLP bf16: max abs err {err}, worst "
          f"error {bf16_excess:.3f}x atol {atol} + rtol {rtol}")
    # (1) one 64-wide f tile of h dropped (its rows of Wd zeroed)
    wd_drop = wd.clone()
    wd_drop[f // 2:f // 2 + 64] = 0
    drop = excess(fm.fused_mlp_plain(x, wg, wu, wd_drop))
    # (2) the down projection split in K as the kernel splits it, each
    # partial rounded to bf16 before the sum
    plan = fm.mlp_plan(t, d, f, torch.cuda.get_device_properties(
        0).multi_processor_count)
    splits = plan[0]
    x32 = x.float()
    h = (torch.nn.functional.silu(x32 @ wg.float())
         * (x32 @ wu.float())).to(bf).float()
    cuts = [f * i // max(splits, 2) for i in range(max(splits, 2) + 1)]
    rounded = sum((h[:, a:b] @ wd[a:b].float()).to(bf).float()
                  for a, b in zip(cuts[:-1], cuts[1:]))
    partials_bf16 = excess(rounded.to(bf))
    del h, rounded, wd_drop

    def atol_needed(a):
        return ((a.float() - want).abs() - rtol * want.abs()).max().item()

    need = {"kernel": atol_needed(got),
            "exact_h": atol_needed(exact_h_mlp(x, wg.double(), wu.double(),
                                               wd.double()))}
    check(drop > 1.0 and partials_bf16 > 1.0,
          f"the bf16 check passes a defective version (dropped f tile "
          f"{drop:.3f}x, bf16 partials {partials_bf16:.3f}x the limit)")
    log(f"[mlp bf16 T={t} d={d} f={f}] kernel vs plain max_abs_err "
        f"{err:.3e}, worst error {bf16_excess:.3f}x the limit (atol {atol}, "
        f"rtol {rtol}; reference rms {want.pow(2).mean().sqrt().item():.3e},"
        f" max {want.abs().max().item():.3e}); a dropped 64-wide f tile "
        f"would be {drop:.1f}x, bf16 down partials ({max(splits, 2)} "
        f"splits) {partials_bf16:.2f}x the limit; atol needed at rtol "
        f"{rtol}: the kernel {need['kernel']:.2e}, an exactly rounded h "
        f"{need['exact_h']:.2e}; plan (down splits, "
        f"gate/up tail units, their splits, scratch floats) {plan}")
    del got, want
    # the row counts of the split path (phase 5b), each with its own plan:
    # a decode of the 4-slot table, the prefill buckets from 32 (a 24-token
    # prompt) to 1024, and generate's (4, 512) prefill; each held to the
    # same per-value limit, and the limit shown to reject a dropped f tile
    split_rows = [_mlp_rows(gen, rows, wg, wu, wd, atol, rtol, timed=False)
                  for rows in MLP_SPLIT_ROWS]
    # the same per-value check on 16 draws of x at every row count and at
    # T = 256, beside the plain version's and the kernel's distance from
    # the exactly rounded h (ROADMAP.md Queue 3, closed)
    sweep = mlp_seed_sweep(wg, wu, wd, atol, rtol)
    for rows, w in sweep.items():
        check(not w["seeds_a_over"], f"fused MLP bf16 at T={rows}: worst "
              f"error {w['a']:.3f}x atol {atol} + rtol {rtol} on seeds "
              f"{w['seeds_a_over']} of {MLP_SWEEP_SEEDS}")
    kernel = time_ms(lambda: fm.fused_mlp(x, wg, wu, wd))
    plain = time_ms(lambda: fm.fused_mlp_plain(x, wg, wu, wd),
                    iters=3, warmup=1)
    silu = torch.nn.functional.silu
    library = time_ms(lambda: torch.matmul(
        silu(torch.matmul(x, wg)) * torch.matmul(x, wu), wd))
    bms, by = bound_ms(fm.cost(t, d, f), "bfloat16")
    log(f"[mlp bf16 T={t}] kernel {kernel:.4f} ms, plain {plain:.4f} ms, "
        f"3x matmul {library:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"name": "fused_mlp", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_mlp.cu",
            "replaces": "src/repro/kernels/fused_mlp.py:47",
            "max_abs_err": err, "max_abs_err_f32": err32,
            "tolerance": "bf16 atol 1e-3 + rtol 8e-3 of each value, fp32 "
                         "atol 1e-5",
            "bf16_worst_error_of_limit": bf16_excess,
            "bf16_dropped_tile_error_of_limit": drop,
            "bf16_partials_error_of_limit": partials_bf16,
            "bf16_atol_needed": need,
            "plan": plan, "split_path_rows": split_rows,
            "seed_sweep": sweep,
            "ms": kernel, "kernel_ms": kernel, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": library,
            "library": "matmul(silu(matmul(x,Wg))*matmul(x,Wu), Wd)"}


#: flash attention's shapes on the split path (phase 5b), (B, S, T, Hq,
#: Hkv, D): each prefill bucket of one prompt, and generate's 4 x 512
FLASH_SPLIT_SHAPES = tuple((1, n, n, 40, 8, 128)
                           for n in (32, 64, 128, 256, 512, 1024)) \
    + ((4, 512, 512, 40, 8, 128),)


def _flash_inputs(gen, shape, dtype):
    b, s, t, hq, hkv, d = shape
    return tuple(torch.randn(sh, generator=gen, device="cuda").to(dtype)
                 for sh in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d)))


def _small_times(kernel, library, plain) -> dict:
    """Times of a kernel call and of the library call beside it at a small
    shape, where a call's host path can take longer than its device work:
    by CUDA-graph replay (the device's time, ``ms``) and eager by CUDA
    events (``eager_ms``, ``library_eager_ms``); the plain version eager
    (3 calls)."""
    return {"ms": graph_ms([kernel]), "eager_ms": time_ms(kernel),
            "library_ms": graph_ms([library]),
            "library_eager_ms": time_ms(library),
            "plain_ms": time_ms(plain, iters=3, warmup=1)}


def _small_times_text(rec: dict, library: str) -> str:
    return (f"; kernel {rec['ms']:.4f} ms by graph replay "
            f"({rec['eager_ms']:.4f} eager), plain {rec['plain_ms']:.4f} "
            f"ms, {library} {rec['library_ms']:.4f} ms by graph replay "
            f"({rec['library_eager_ms']:.4f} eager), bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def _flash_shape(gen, shape, atol: float, rtol: float, *, timed: bool,
                 causal: bool = True):
    """bf16 flash at ``shape`` against its plain version, per value (worst
    |err| / (atol + rtol |want|) <= 1), the check shown to reject a
    defective version: causal, one that drops keys from the last rows;
    non-causal, one that drops the last key tile (the ragged tail past the
    last multiple of 128 keys, or the last 128). ``timed``: kernel, plain
    version, SDPA and the bound too. Returns the shape's record."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_inputs(gen, shape, torch.bfloat16)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    got = fa.flash_attention(q, k, v, causal=causal)
    e = worst_excess(got, want, atol, rtol)
    n, t = shape[1], shape[2]
    if causal:
        what = "drops keys"
        bad = fa.flash_attention_plain(q, k, v, causal=True,
                                       window=n - min(64, n // 2))
    else:
        keep = t - (t % 128 or 128)
        what = f"drops keys {keep}-{t - 1}"
        bad = fa.flash_attention_plain(q, k[:, :keep], v[:, :keep],
                                       causal=False)
    dr = worst_excess(bad, want, atol, rtol)
    mode = "causal" if causal else "non-causal"
    check(bool(torch.isfinite(got).all()) and e <= 1.0,
          f"flash bf16 at {shape} {mode}: worst error {e:.3f}x atol "
          f"{atol} + rtol {rtol}")
    check(dr > 1.0, f"the bf16 flash check at {shape} passes a version "
                    f"that {what} ({dr:.3f}x the limit)")
    rec = {"shape": list(shape), "causal": causal, "error_of_limit": e,
           "dropped_keys_error_of_limit": dr}
    msg = (f"[flash bf16 {shape} {mode}] worst error {e:.3f}x the limit "
           f"(atol {atol}, rtol {rtol}); a version that {what} would be "
           f"{dr:.1f}x")
    if timed:
        b, s, t, hq, hkv, d = shape
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def kernel():
            return fa.flash_attention(q, k, v, causal=causal)

        def library():
            return sdpa(qs, ks, vs, is_causal=causal, enable_gqa=hq != hkv)

        rec.update(_small_times(kernel, library, lambda:
                                fa.flash_attention_plain(q, k, v,
                                                         causal=causal)))
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            fa.cost(b, s, t, hq, hkv, d, causal=causal), "bfloat16")
        msg += _small_times_text(rec, "sdpa")
    log(msg)
    return rec


def phase_flash(rng):
    """Flash attention: (a) bf16 at the training shape, (b) fp32 at a
    small shape, (c) ragged / windowed / non-causal fp32 cases, (d) the
    gradients of the autograd.Function against autograd through the
    plain version; then times at the training shape."""
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    # (a) bf16, B = 1, S = T = 4096, Hq/Hkv = 40/8, D = 128, causal. Both
    # compute in fp32 from the same bf16 inputs and round the output to
    # bf16 once, so a correct kernel is off by at most one bf16 ulp of each
    # value (2^-7 of it at most); the limit is relative to each value, as a
    # row attending to n keys has |out| ~ sqrt(e / n), ~0.03 at mid rows.
    atol, rtol = 1e-5, 8e-3
    train_shape = (1, 4096, 4096, 40, 8, 128)
    q, k, v = _flash_inputs(gen, train_shape, torch.bfloat16)
    got = fa.flash_attention(q, k, v, causal=True).float()
    want = fa.flash_attention_plain(q, k, v, causal=True).float()
    torch.cuda.synchronize()

    def excess(a):                    # worst |a - want| / (atol + rtol|want|)
        return ((a - want).abs() / (atol + rtol * want.abs())).max().item()

    err, bf16_excess = (got - want).abs().max().item(), excess(got)
    check(bool(torch.isfinite(got).all()), "flash output finite")
    check(bf16_excess <= 1.0, f"flash bf16 training shape: max abs err "
          f"{err}, worst error {bf16_excess:.3f}x atol {atol} + rtol {rtol}")
    # the same check rejects a defect of one tile: the plain version with
    # window 4032 drops up to 64 keys from the last 64 query rows only
    drop = excess(fa.flash_attention_plain(q, k, v, causal=True,
                                           window=4096 - 64).float())
    check(drop > 1.0, f"the bf16 check passes a version that drops keys "
                      f"(worst error {drop:.3f}x the limit)")
    log(f"[flash bf16 B=1 S=T=4096 40/8x128 causal] kernel vs plain "
        f"max_abs_err {err:.3e}, worst error {bf16_excess:.3f}x the limit "
        f"(atol {atol}, rtol {rtol}; reference rms "
        f"{want.pow(2).mean().sqrt().item():.3e}, max "
        f"{want.abs().max().item():.3e}); one dropped key tile would be "
        f"{drop:.1f}x the limit")
    del got, want
    # the split path's prefill shapes (phase 5b): one prompt padded to its
    # bucket (32 to 1024 positions) and generate's (4, 512) batch, each
    # held to the same per-value limit and shown to reject a version that
    # drops keys from its last rows
    split_shapes = [_flash_shape(gen, shape, atol, rtol, timed=False)
                    for shape in FLASH_SPLIT_SHAPES]
    # (b), (c): fp32, 2e-6 as tests/test_kernels.py:33
    cases = [((2, 256, 256, 8, 2, 64), True, 0, "small causal GQA"),
             ((1, 100, 77, 4, 2, 16), True, 0, "ragged S > T"),
             ((1, 70, 133, 4, 4, 64), False, 30, "ragged non-causal window"),
             ((1, 200, 200, 4, 2, 64), True, 50, "causal window"),
             ((2, 96, 96, 2, 1, 32), False, 0, "non-causal")]
    err32 = 0.0
    for shape, causal, window, what in cases:
        a = _flash_inputs(gen, shape, torch.float32)
        e = (fa.flash_attention(*a, causal=causal, window=window)
             - fa.flash_attention_plain(*a, causal=causal, window=window)
             ).abs().max().item()
        check(e <= 2e-6, f"flash fp32 {what} {shape}: max abs err {e} > 2e-6")
        log(f"[flash f32 {what} {shape} causal={causal} window={window}] "
            f"max_abs_err {e:.3e} (atol 2e-6)")
        err32 = max(err32, e)
    # (d) gradients, 2e-5 / 2e-4 as tests/test_kernels.py:173
    grad_err = 0.0
    for shape, causal, window, what in (cases[0], cases[3]):
        leaves = [x.requires_grad_(True)
                  for x in _flash_inputs(gen, shape, torch.float32)]
        got_g = torch.autograd.grad((fa.flash_attention(
            *leaves, causal=causal, window=window) ** 2).mean(), leaves)
        want_g = torch.autograd.grad((fa.flash_attention_plain(
            *leaves, causal=causal, window=window) ** 2).mean(), leaves)
        for name, g, w in zip("qkv", got_g, want_g):
            ok = torch.allclose(g, w, atol=2e-5, rtol=2e-4)
            e = (g - w).abs().max().item()
            check(ok, f"flash d{name} {what}: max abs err {e} vs autograd "
                      f"of plain (atol 2e-5, rtol 2e-4)")
            grad_err = max(grad_err, e)
    log(f"[flash grads f32] autograd.Function vs autograd through plain: "
        f"max abs err {grad_err:.3e} (atol 2e-5, rtol 2e-4)")
    # times at the training shape (bf16): kernel, plain, SDPA, backward
    kernel = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True),
                    iters=3, warmup=1)
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = time_ms(lambda: sdpa(qs, ks, vs, is_causal=True,
                                   enable_gqa=True))
    del qs, ks, vs
    g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    backward = time_ms(lambda: fa.flash_attention_bwd(q, k, v, g,
                                                      causal=True),
                       iters=3, warmup=1)
    b, s, t, hq, hkv, d = train_shape
    flops, nbytes = fa.cost(b, s, t, hq, hkv, d)   # live causal (q, k) pairs
    bms, by = bound_ms((flops, nbytes), "bfloat16")
    # the kernel keeps P fp32 in P.V as two bf16 products, P_hi V + P_lo V:
    # 1.5x the tensor-core work of the function
    split_ms = bound_ms((1.5 * flops, nbytes), "bfloat16")[0]
    log(f"[flash bf16 training shape] kernel {kernel:.4f} ms, plain "
        f"{plain:.4f} ms, sdpa {library:.4f} ms, bound {bms:.4f} ms ({by}, "
        f"{flops / 1e9:.1f} GFLOP; {split_ms:.4f} ms for the split P.V); "
        f"backward (plain softmax recompute) {backward:.4f} ms")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:124",
            "max_abs_err": err, "max_abs_err_f32": err32,
            "max_abs_err_grads_f32": grad_err,
            "tolerance": "bf16 atol 1e-5 rtol 8e-3; fp32 atol 2e-6; grads "
                         "atol 2e-5 rtol 2e-4",
            "bf16_worst_error_of_limit": bf16_excess,
            "bf16_dropped_tile_error_of_limit": drop,
            "split_path_shapes": split_shapes,
            "ms": kernel, "kernel_ms": kernel, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "bound_split_p_ms": split_ms,
            "library_ms": library,
            "library": "scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True)",
            "backward_ms": backward}


def _ssd_inputs(gen, shape, dtype, *, model_decay=False):
    """x, dt, A, B, C for the SSD kernel. x, B and C are views into one
    (b, s, h p + 2 n) buffer, as ``mamba_forward`` hands them over.
    ``model_decay``: dt and A from the model's init formulas
    (``ssm.py::init_mamba``: dt = softplus(u + dt_bias), A = -exp(A_log));
    else the distributions of tests/test_kernels.py."""
    b, s, h, p, n = shape

    def rnd(*sh):
        return torch.randn(sh, generator=gen, device="cuda")

    buf = torch.cat([rnd(b, s, h * p) * 0.5, rnd(b, s, 2 * n) * 0.3],
                    dim=-1).to(dtype)
    x = buf[..., :h * p].reshape(b, s, h, p)
    bm, cm = buf[..., h * p:h * p + n], buf[..., h * p + n:]
    if model_decay:
        lin = torch.linspace(1e-3, 1e-1, h, device="cuda")
        dt_bias = torch.log(torch.expm1(lin))
        dt = torch.nn.functional.softplus(rnd(b, s, h) * 0.5 + dt_bias)
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
    else:
        dt = torch.nn.functional.softplus(rnd(b, s, h))
        A = -torch.exp(rnd(h))
    return x, dt, A, bm, cm


#: the SSD scan's launches, in order (csrc/ssd_scan.cu)
SSD_LAUNCHES = ("ssd_prep_kernel", "ssd_state_kernel", "ssd_pass_kernel",
                "ssd_chunk_scan_kernel")


def phase_ssd(rng):
    """The SSD chunked scan: (a) bf16 at the serving path's prefill shape
    (b 1, s 1024, h 48, p 64, n 128, chunk 128), (b) fp32 at small shapes
    with a ragged chunk (s 77 at chunk 128) and several chunks (s 96 at
    chunk 32); then times at the path's shape."""
    from repro_torch.kernels import ssd_scan as sk
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    # (a) both sides compute in fp32 from the same bf16 inputs and round y
    # once: one bf16 ulp of each value, the flash rule; the final state is
    # fp32 on both sides: 1e-4 of its largest value
    atol, rtol, h_rtol = 1e-5, 8e-3, 1e-4
    path = (1, 1024, 48, 64, 128)
    chunk = 128
    args = _ssd_inputs(gen, path, torch.bfloat16, model_decay=True)
    y, h_last = sk.ssd_scan(*args, chunk=chunk)
    want_y, want_h = sk.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    y, want_y = y.float(), want_y.float()

    def excess(a, w):                 # worst |a - w| / (atol + rtol |w|)
        return ((a - w).abs() / (atol + rtol * w.abs())).max().item()

    err = (y - want_y).abs().max().item()
    bf16_excess = excess(y, want_y)
    h_err = ((h_last - want_h).abs().max() / want_h.abs().max()).item()
    check(bool(torch.isfinite(y).all() and torch.isfinite(h_last).all()),
          "ssd output finite")
    check(bf16_excess <= 1.0, f"ssd bf16 path shape: y max abs err {err}, "
          f"worst error {bf16_excess:.3f}x atol {atol} + rtol {rtol}")
    check(h_err <= h_rtol, f"ssd bf16 path shape: final state max err "
          f"{h_err:.3e} of its largest value > {h_rtol}")
    # the same check rejects a defect of the state passing: the last chunk
    # scanned from a zero state (its carried-state term dropped)
    tail = [a[:, -chunk:] for a in (args[0], args[1])]
    bad, _ = sk.ssd_scan_plain(tail[0], tail[1], args[2], args[3][:, -chunk:],
                               args[4][:, -chunk:], chunk=chunk)
    drop = excess(bad.float(), want_y[:, -chunk:])
    check(drop > 1.0, f"the bf16 check passes a scan that drops the carried "
                      f"state (worst error {drop:.3f}x the limit)")
    log(f"[ssd bf16 b=1 s=1024 h=48 p=64 n=128 chunk=128] kernel vs plain "
        f"y max_abs_err {err:.3e}, worst error {bf16_excess:.3f}x the limit "
        f"(atol {atol}, rtol {rtol}; reference rms "
        f"{want_y.pow(2).mean().sqrt().item():.3e}, max "
        f"{want_y.abs().max().item():.3e}); final state err {h_err:.3e} of "
        f"its max (<= {h_rtol}); a dropped carried state would be "
        f"{drop:.1f}x the limit")
    del y, want_y, bad
    # (b) fp32, 1e-4 as tests/test_kernels.py:118; final state 1e-4 relative
    cases = [((1, 77, 2, 64, 128), 128, "ragged single chunk q=77"),
             ((1, 96, 2, 16, 16), 32, "three chunks of 32"),
             ((2, 256, 3, 64, 32), 64, "reference sweep")]
    err32 = h_err32 = 0.0
    for shape, ck, what in cases:
        a = _ssd_inputs(gen, shape, torch.float32)
        gy, gh = sk.ssd_scan(*a, chunk=ck)
        wy, wh = sk.ssd_scan_plain(*a, chunk=ck)
        check(torch.allclose(gy, wy, atol=1e-4, rtol=1e-4),
              f"ssd fp32 {what} {shape}: y max abs err "
              f"{(gy - wy).abs().max().item()} > atol=rtol=1e-4")
        e = (gy - wy).abs().max().item()
        he = ((gh - wh).abs().max() / wh.abs().max()).item()
        check(he <= 1e-4, f"ssd fp32 {what}: final state err {he} > 1e-4")
        log(f"[ssd f32 {what} {shape} chunk={ck}] y max_abs_err {e:.3e} "
            f"(atol=rtol=1e-4), final state err {he:.3e} of its max")
        err32, h_err32 = max(err32, e), max(h_err32, he)
    # times at the path's shape (bf16); no PyTorch call computes the scan
    kernel = time_ms(lambda: sk.ssd_scan(*args, chunk=chunk))
    launches = device_us(lambda: sk.ssd_scan(*args, chunk=chunk))
    plain = time_ms(lambda: sk.ssd_scan_plain(*args, chunk=chunk),
                    iters=3, warmup=1)
    check(kernel < plain, f"ssd kernel {kernel:.4f} ms is not faster than "
          f"its plain version ({plain:.4f} ms)")
    check(all(k in launches for k in SSD_LAUNCHES) or not launches,
          f"ssd launches {sorted(launches)} lack one of {SSD_LAUNCHES}")
    b, s, h, p, n = path
    # each input read once, each output written once; C B^T once a chunk,
    # the intra y over its causal pairs, the inter y and the state a head
    flops, nbytes = sk.cost(b, s, h, p, n, chunk=chunk)
    bms, by = bound_ms((flops, nbytes), "bfloat16")
    grids = sk.pass_grids(b, s, h, p, n, chunk)
    log(f"[ssd bf16 path shape] kernel {kernel:.4f} ms (device: "
        + ", ".join(f"{k} {v:.1f} us" for k, v in launches.items())
        + f"), plain {plain:.4f} "
        f"ms, library none, bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB "
        f"at 3.35 TB/s vs {flops / 1e9:.3f} GFLOP at the bf16 peak of "
        f"989 TFLOP/s; {flops / 67e12 * 1e3:.4f} ms at the fp32 CUDA-core "
        f"peak of 67 TFLOP/s); blocks a pass {grids} on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:65",
            "max_abs_err": err, "max_abs_err_f32": err32,
            "state_err_of_max": h_err, "state_err_of_max_f32": h_err32,
            "tolerance": "bf16 y atol 1e-5 rtol 8e-3; fp32 y atol=rtol="
                         "1e-4; final state 1e-4 of its max",
            "bf16_worst_error_of_limit": bf16_excess,
            "bf16_dropped_state_error_of_limit": drop,
            "ms": kernel, "kernel_ms": kernel, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "launch_kernels": list(SSD_LAUNCHES),
            "device_us_by_launch": launches, "blocks_by_pass": grids,
            "library": "none: no one PyTorch call computes the SSD scan"}


#: the hybrid's kernel shapes (Zamba2-1.2B: the shared block's 32/32 heads
#: x 64 and its 2048 x 8192 MLP, 64 SSD heads x p 64 with n 64), every one
#: that phases 11 and 12 launch: one prompt of each length phase 11 and its
#: profile prefill (77 to 1024 tokens), generate's 4 x 512 (2048 MLP rows)
#: and phase 12's training forward (1 x 4096, flash only: the MLP and the
#: SSD scan train through their plain versions); the MLP also at a 4-slot
#: decode, and its seed sweep at 256 rows and at the two largest prefills
HYBRID_PROMPTS = (77, 128, 256, 384, 512, 640, 1024)
HYBRID_FLASH = tuple((1, n, n, 32, 32, 64) for n in HYBRID_PROMPTS) \
    + ((4, 512, 512, 32, 32, 64), (1, 4096, 4096, 32, 32, 64))
HYBRID_MLP = (2048, 8192, (4,) + HYBRID_PROMPTS + (2048,),
              (256, 1024, 2048))
HYBRID_SSD = tuple((1, n, 64, 64, 64) for n in HYBRID_PROMPTS) \
    + ((4, 512, 64, 64, 64),)


def phase_hybrid_kernels(rng):
    """Flash attention, the fused MLP and the SSD scan in bf16 at the
    hybrid's shapes (``HYBRID_*``), each held to the per-value limit of its
    phase-3 check (shown again to reject a defective plain variant) and
    timed beside its plain version, the PyTorch library call where there
    is one, and its bound. Returns {kernel name: [shape records]} and the
    MLP's seed sweep."""
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    bf = torch.bfloat16
    out = {"flash_attention": [_flash_shape(gen, shape, 1e-5, 8e-3,
                                            timed=True)
                               for shape in HYBRID_FLASH]}
    d, f, rows_list, sweep_rows = HYBRID_MLP
    atol, rtol = 1e-3, 8e-3
    wg = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wu = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wd = (torch.randn((f, d), generator=gen, device="cuda")
          * (0.02 / math.sqrt(2 * 38))).to(bf)
    out["fused_mlp"] = [_mlp_rows(gen, rows, wg, wu, wd, atol, rtol,
                                  timed=True) for rows in rows_list]
    sweep = mlp_seed_sweep(wg, wu, wd, atol, rtol, row_counts=sweep_rows)
    for rows, w in sweep.items():
        check(not w["seeds_a_over"], f"fused MLP bf16 at the hybrid's "
              f"T={rows}: worst error {w['a']:.3f}x the limit on seeds "
              f"{w['seeds_a_over']} of {MLP_SWEEP_SEEDS}")
    out["fused_mlp_seed_sweep"] = sweep
    del wg, wu, wd
    out["ssd_scan"] = [_ssd_shape(gen, shape, "the hybrid's")
                       for shape in HYBRID_SSD]
    return out


def _ssd_shape(gen, shape, what: str, chunk: int = 128):
    """The bf16 SSD scan at ``shape`` (the model's decay) against its plain
    version: y within atol 1e-5 + rtol 8e-3 of each value, the final state
    within 1e-4 of its largest value, the check shown to reject a scan
    that drops the carried state (where there is more than one chunk);
    timed by graph replay and eager beside the plain version, with its
    bound. Returns the shape's record."""
    from repro_torch.kernels import ssd_scan as sk
    atol, rtol = 1e-5, 8e-3
    args = _ssd_inputs(gen, shape, torch.bfloat16, model_decay=True)
    y, h_last = sk.ssd_scan(*args, chunk=chunk)
    want_y, want_h = sk.ssd_scan_plain(*args, chunk=chunk)
    e = worst_excess(y, want_y, atol, rtol)
    h_err = ((h_last - want_h).abs().max() / want_h.abs().max()).item()
    check(bool(torch.isfinite(y).all()) and e <= 1.0 and h_err <= 1e-4,
          f"ssd bf16 at {what} {shape}: y worst error {e:.3f}x the limit, "
          f"final state err {h_err:.3e} of its max")
    b, s, h, p, n = shape
    if s > chunk:               # the last chunk scanned from a zero state
        bad, _ = sk.ssd_scan_plain(
            args[0][:, -chunk:], args[1][:, -chunk:], args[2],
            args[3][:, -chunk:], args[4][:, -chunk:], chunk=chunk)
        dr = worst_excess(bad, want_y[:, -chunk:], atol, rtol)
        check(dr > 1.0, f"the bf16 ssd check at {shape} passes a scan that "
                        f"drops the carried state ({dr:.3f}x)")
    else:
        dr = None
    kernel = graph_ms([lambda: sk.ssd_scan(*args, chunk=chunk)])
    eager = time_ms(lambda: sk.ssd_scan(*args, chunk=chunk))
    plain = time_ms(lambda: sk.ssd_scan_plain(*args, chunk=chunk),
                    iters=3, warmup=1)
    # a prompt under one chunk: q = s (sk.chunk_rows)
    flops, nbytes = sk.cost(b, s, h, p, n, chunk=chunk)
    bms, by = bound_ms((flops, nbytes), "bfloat16")
    log(f"[ssd bf16 {shape} chunk={chunk}] y worst error {e:.3f}x the "
        f"limit, final state err {h_err:.3e} of its max"
        + (f", a dropped carried state {dr:.1f}x" if dr else "")
        + f"; kernel {kernel:.4f} ms by graph replay ({eager:.4f} eager), "
        f"plain {plain:.4f} ms, library none, bound {bms:.4f} ms ({by})")
    return {"shape": list(shape), "chunk": chunk, "error_of_limit": e,
            "state_err_of_max": h_err, "dropped_state_error_of_limit": dr,
            "ms": kernel, "eager_ms": eager, "plain_ms": plain,
            "library_ms": None, "bound_ms": bms, "bound_by": by}


#: OLMoE-1B-7B's attention (phases 13, 13b and 14): Hq = Hkv = 16 heads of
#: D 128, so rep 1 at D 128; phase 13b's profiled pair of prompts (its
#: other prefills are phase 5's six prompt lengths, at their exact length:
#: an MoE prefill is not bucketed) and phase 14's 1 x 4096 training forward
MOE_HEADS = (16, 16)
MOE_PROFILE_PROMPTS = (600, 40)


def moe_flash_shapes(seed: int):
    """Flash attention's shapes on phases 13b and 14 at ``seed``: one
    (1, S, S, 16, 16, 128) a distinct prompt length, the profiled pair's
    lengths and the training forward's S 4096."""
    lens, _ = serving_prompts(seed, 2)
    hq, hkv = MOE_HEADS
    return tuple((1, n, n, hq, hkv, 128) for n in sorted(
        {int(n) for n in lens} | set(MOE_PROFILE_PROMPTS))) \
        + ((1, 4096, 4096, hq, hkv, 128),)


def _paged_cases(rng, heads, head_dim: int, cases, tag: str, *,
                 gather_atol=1e-2, **inputs_kw):
    """bf16 paged attention at ``heads`` (Hq, Hkv) x ``head_dim`` on each
    of ``cases`` — (name, ``attention_inputs`` keywords, (row, page) to
    drop, timed) — per value against the fp32-P plain version (atol 1e-5
    + rtol 8e-3), per value against the gather plain version within the
    gather's own rounding (``gather_bound``) and, unless ``gather_atol``
    is None, within ``gather_atol`` of it; its device plan equal to
    ``tile_plan`` and the check shown to reject a run with a live page
    dropped; a timed case by graph replay beside SDPA on the gathered KV,
    with its bound. ``inputs_kw`` go to every ``attention_inputs`` call.
    Returns {case name: record}."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.kvcache import gather_pages
    bf = torch.bfloat16
    hq, hkv = heads
    d, rep, esize = head_dim, hq // hkv, 2
    atol, rtol = 1e-5, 8e-3
    sdpa = torch.nn.functional.scaled_dot_product_attention
    paged = {}
    for name, kw, drop_at, timed in cases:
        q, pools, tab, pos, live_tokens, *_ = attention_inputs(
            rng, bf, n_layers_copies=8 if timed else 1, heads=heads,
            head_dim=d, **inputs_kw, **kw)
        kp, vp = pools[0]
        got = pa.paged_attention(q, kp, vp, tab, pos)
        want = pa.paged_attention_plain_f32p(q, kp, vp, tab, pos)
        e = worst_excess(got, want, atol, rtol)
        gather = pa.paged_attention_plain(q, kp, vp, tab, pos)
        e_gather = (got.float() - gather.float()).abs().max().item()
        e_gather_pv = gather_bound(got, gather, q, kp, vp, tab, pos)
        items, splits = pa.device_tile_plan(tab, pos, 16, rep)
        want_items, want_splits = pa.tile_plan(tab.cpu().numpy(),
                                               pos.cpu().numpy(), 16, rep)
        dropped = tab.clone()
        dropped[drop_at] = 0
        dr = worst_excess(pa.paged_attention(q, kp, vp, dropped, pos), want,
                          atol, rtol)
        check(bool(torch.isfinite(got).all()) and e <= 1.0
              and e_gather_pv <= 1.0
              and (gather_atol is None or e_gather <= gather_atol),
              f"paged attention bf16 at {tag}'s heads, {name}: {e:.3f}x "
              f"the per-value limit, {e_gather:.3e} from the gather plain "
              f"version ({e_gather_pv:.3f}x its rounding bound, atol "
              f"{gather_atol})")
        check(items == want_items and (splits == want_splits).all(),
              f"paged attention at {tag}'s heads, {name}: device plan "
              f"{items} != tile_plan {want_items}")
        check(dr > 1.0, f"the per-value check at {tag}'s heads, {name}, "
                        f"passes a run with a live page dropped ({dr:.3f}x)")
        rec = {"mix": name, "heads": [hq, hkv, d], "error_of_limit": e,
               "max_abs_err_gather": e_gather,
               "gather_error_of_bound": e_gather_pv,
               "dropped_page_error_of_limit": dr, "items": len(items)}
        msg = (f"[attention bf16 {tag} {hq}/{hkv}x{d} {name}] per value "
               f"{e:.3f}x the limit, vs gather {e_gather:.3e} "
               f"({e_gather_pv:.3f}x its rounding bound"
               + ("" if gather_atol is None else f", atol {gather_atol}")
               + "); "
               f"{len(items)} work items, device plan = tile_plan; a "
               f"dropped live page would be {dr:.1f}x the limit")
        if timed:
            it = {"i": 0}

            def nxt():
                it["i"] = (it["i"] + 1) % len(pools)
                return pools[it["i"]]

            kernel = graph_ms([lambda kv=kv: pa.paged_attention(q, *kv, tab,
                                                                pos)
                               for kv in pools])
            eager = time_ms(lambda: pa.paged_attention(q, *nxt(), tab, pos))
            plain = time_ms(lambda: pa.paged_attention_plain(
                q, *nxt(), tab, pos), iters=3, warmup=1)
            # SDPA over the gathered, GQA-expanded KV (as phase 3's main
            # row: the gather and the expansion are done before the timing)
            kg = gather_pages(kp, tab).transpose(1, 2).repeat_interleave(
                rep, 1)
            vg = gather_pages(vp, tab).transpose(1, 2).repeat_interleave(
                rep, 1)
            mask = (torch.arange(kg.shape[2], device="cuda")[None, :]
                    < (pos.long() + 1)[:, None])[:, None, None, :]
            qs = q.transpose(1, 2)
            library = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask))
            del kg, vg
            # the distinct live pages (pa.live_tokens: a page rows of two
            # slots share is read once)
            bms, by = bound_ms(pa.cost(tab.cpu().numpy(), pos.cpu().numpy(),
                                       hq, hkv, d, 16, esize=esize),
                               "bfloat16")
            rec.update({"ms": kernel, "eager_ms": eager, "plain_ms": plain,
                        "library_ms": library, "bound_ms": bms,
                        "bound_by": by})
            msg += (f"; kernel {kernel:.4f} ms by graph replay ({eager:.4f} "
                    f"eager), plain {plain:.4f} ms, sdpa {library:.4f} ms, "
                    f"bound {bms:.4f} ms ({by}, {live_tokens} live tokens)")
        log(msg)
        paged[name] = rec
        del pools
    return paged


def gather_bound(got, gather, q, kp, vp, tab, pos) -> float:
    """The worst |kernel - gather| / bound over all values, bound = 1e-5 +
    u (2 sum_j p_j |v_j| + |gather|), u = 2^-8 the unit roundoff of bf16:
    the gather plain version rounds each probability to bf16 before P.V
    (<= u sum_j p_j |v_j| in the sum), and both round the output to bf16
    once (<= u |gather| and <= u |kernel| <= u sum_j p_j |v_j|). <= 1
    passes. Where a row attends to few keys (a prefill chunk's first
    rows), p is near 1 and this exceeds a fixed 1e-2: the gather's own
    rounding, not the kernel's error."""
    from repro_torch.kernels import paged_attention as pa
    pv = pa.paged_attention_plain_f32p(q, kp, vp.abs(), tab, pos).float()
    gather = gather.float()
    return ((got.float() - gather).abs()
            / (1e-5 + 2.0 ** -8 * (2 * pv + gather.abs()))).max().item()


def _idle_slot_3(tables):                     # a retired slot's table row
    tables[3] = 0


def phase_moe_kernels(seed: int):
    """Paged attention and flash attention in bf16 at OLMoE-1B-7B's heads
    (``MOE_HEADS``), every shape phases 13, 13b and 14 launch: paged
    attention (``_paged_cases``) at the T = 256 mix and the decode-only
    mix (phase 13's mixed step), both timed, and at the split path's 4-row
    decode table with and without an idle slot (phase 13b). Flash at
    ``moe_flash_shapes``, per value (shown to reject dropped keys), timed
    beside SDPA with its bound. Inputs come from a generator of their own,
    so the other phases see the inputs they saw before. Returns {kernel
    name: records}."""
    rng = np.random.default_rng(seed + 2409)
    paged = _paged_cases(rng, MOE_HEADS, 128, (
        ("T256", dict(rows=MIX_T256), (slice(3, None), 5), True),
        ("decode_only", dict(rows=MIX_DECODE), (0, 10), True),
        ("split", dict(rows=MIX_SPLIT), (2, 10), False),
        ("split_idle", dict(rows=MIX_SPLIT_IDLE, edit=_idle_slot_3),
         (1, 5), False)), "OLMoE")
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    flash = [_flash_shape(gen, shape, 1e-5, 8e-3, timed=True)
             for shape in moe_flash_shapes(seed)]
    return {"paged_attention": paged, "flash_attention": flash}


#: whisper-tiny's heads (Hq, Hkv), head dim, and phases 15-16's shapes: 8
#: slots x 448 decoder tokens of 16-token pages (28 pages a slot, a pool of
#: 225 with the null page), 1500 encoder frames, training at 8 x 448
WHISPER_HEADS, WHISPER_D = (6, 6), 64
WHISPER_SLOTS, WHISPER_MAX_LEN, WHISPER_NEW, WHISPER_TRAIN = 8, 448, 64, 448
#: tokens held per slot in the paged mixes (prompts of up to 224 tokens
#: plus 64 new ones), and the mixes: a T = 256 step with seven decode rows
#: beside slot 6's 224-token prefill chunk and 25 pads (slot 0, position
#: 0, as the engine packs them); a decode-only step of 8 rows and 248 pads
WHISPER_CTX = (288, 70, 200, 150, 260, 31, 224, 100)
WHISPER_T256 = ([0, 1, 2, 3, 4, 5, 7] + [6] * 224 + [0] * 25,
                [287, 69, 199, 149, 259, 30, 99] + list(range(224))
                + [0] * 25)
WHISPER_DECODE = (list(range(8)) + [0] * 248,
                  [287, 69, 199, 149, 259, 30, 223, 99] + [0] * 248)
#: the profiled pair of phase 15: prompt lengths
WHISPER_PROFILE_PROMPTS = (200, 20)


def whisper_requests(seed: int, vocab: int, d_model: int = 384,
                     frames: int = 1500):
    """Phases 15 and 15b's 8 requests from ``seed``: prompts of 4-224
    tokens below ``vocab`` (Whisper's previous-text prompt is at most half
    its 448-token decoder context) and each request's own (frames,
    d_model) float32 frame embeddings, drawn in one block. Returns
    (lengths, prompts, frames)."""
    rng = np.random.default_rng(seed + 1500)
    lens = rng.integers(4, 225, size=WHISPER_SLOTS)
    prompts = [rng.integers(0, vocab, size=(int(n),)) for n in lens]
    block = rng.standard_normal((WHISPER_SLOTS, frames, d_model),
                                dtype=np.float32)
    return lens, prompts, list(block)


def whisper_flash_shapes(seed: int):
    """Flash attention's shapes on phases 15, 15b and 16 at ``seed``,
    (B, S, T, Hq, Hkv, D, causal): the encoder, non-causal over 1500
    frames, at an admission (B 1) and a training step (B 8); the decoder,
    causal, at each distinct prompt length of phase 15b (B 1, exact: an
    enc-dec prefill is not bucketed) and at the training rows (8 x
    448)."""
    lens, _, _ = whisper_requests(seed, 2, frames=1)
    hq, hkv = WHISPER_HEADS
    d = WHISPER_D
    return ((1, 1500, 1500, hq, hkv, d, False),
            (8, 1500, 1500, hq, hkv, d, False)) \
        + tuple((1, n, n, hq, hkv, d, True)
                for n in sorted({int(n) for n in lens})) \
        + ((8, WHISPER_TRAIN, WHISPER_TRAIN, hq, hkv, d, True),)


def phase_whisper_kernels(seed: int):
    """Paged attention and flash attention in bf16 at whisper-tiny's heads
    (6/6 x 64: rep 1, D 64), every shape phases 15, 15b and 16 launch:
    paged attention (``_paged_cases``) at phase 15's T = 256 mix and
    decode-only mix over 8 slots x 448 tokens (both timed) and at the
    split path's 8-row decode table (phase 15b); flash non-causal at the
    encoder's (1, 1500, 1500) and the training step's (8, 1500, 1500),
    each shown to reject a version that drops the last, ragged key tile
    (keys 1408-1499), and causal at ``whisper_flash_shapes``' decoder
    shapes, each shown to reject dropped keys; all per value, timed beside
    SDPA with their bound. Inputs come from a generator of their own.
    Returns {kernel name: records}."""
    rng = np.random.default_rng(seed + 448)
    split = (list(range(8)), list(WHISPER_DECODE[1][:8]))
    paged = _paged_cases(rng, WHISPER_HEADS, WHISPER_D, (
        ("T256", dict(rows=WHISPER_T256), (slice(7, 231), 5), True),
        ("decode_only", dict(rows=WHISPER_DECODE), (0, 10), True),
        ("split", dict(rows=split), (4, 12), False)), "whisper-tiny",
        gather_atol=None, ctx=WHISPER_CTX, width=28, n_pages=225)
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    flash = [_flash_shape(gen, shape[:6], 1e-5, 8e-3, timed=True,
                          causal=shape[6])
             for shape in whisper_flash_shapes(seed)]
    return {"paged_attention": paged, "flash_attention": flash}


# ------------------------------------------------------------------ phase 4

#: phase 4's tiny f32 dense config, and the engine layouts it is served
#: on: the mixed step (the default), the split path on the pool and on
#: the dense layout, and the sliding-window ring (window 16, prompts up
#: to 40 tokens: the ring wraps, and the 23- and 40-token prompts prefill
#: at their exact length as their buckets pass the window)
PARITY_LAYOUTS = {"mixed": ({}, dict(chunk_tokens=16)),
                  "split": ({}, dict(mixed=False)),
                  "dense": ({}, dict(paged=False)),
                  "swa ring": (dict(sliding_window=16), {})}


def _want_launches(eng, layers: int) -> dict:
    """Every kernel's launches a run of ``eng`` on the card must show: the
    mixed step runs paged attention and the fused MLP once a layer a
    program; the split path runs flash once a layer a prefill, the fused
    MLP once a layer a program (prefill or decode) and, on the pool,
    paged attention once a layer a decode."""
    st = eng.stats
    if eng.mixed:
        n = layers * st["mixed_steps"]
        return {"paged_attention": n, "fused_mlp": n, "flash_attention": 0,
                "ssd_scan": 0}
    pf, dec = st["prefills"], st["decode_steps"]
    return {"paged_attention": layers * dec if eng.paged else 0,
            "fused_mlp": layers * (pf + dec),
            "flash_attention": layers * pf, "ssd_scan": 0}


def phase_parity():
    """The tiny f32 dense config (TF32 off) through the port's engine on
    the card and on the CPU, on each of ``PARITY_LAYOUTS``: first-step
    logits within 1e-4, greedy streams identical, and on the card every
    kernel of the layout's path launched as ``_want_launches`` says.
    Returns the first-step error of each layout."""
    from repro_torch import kernels
    from repro_torch.configs.base import ModelConfig
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = ModelConfig(name="pal-dense", arch_type="dense", num_layers=2,
                       d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                       vocab_size=128, dtype="float32")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, size=(n,)).astype(np.int32)
               for n in (5, 23, 9, 40, 6)]
    errs = {}
    for name, (cfg_kw, eng_kw) in PARITY_LAYOUTS.items():
        cfg = base.with_(**cfg_kw)
        cpu = init_params(cfg, device="cpu", seed=3)
        engines, outs = {}, {}
        for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
            eng = ServeEngine(cfg, params, slots=2, max_len=64, **eng_kw)
            for i, p in enumerate(prompts):
                eng.submit(i, p, max_new=6)
            kernels.reset_launches()
            eng.step()
            engines[dev] = (eng, eng.last_logits.detach().float().cpu())
            res = eng.run()
            outs[dev] = {i: list(res[i].out) for i in res}
            want = _want_launches(eng, cfg.num_layers) if dev == "cuda" \
                else dict.fromkeys(kernels.launches(), 0)
            check(kernels.launches() == want,
                  f"[parity {name}] launches on {dev} {kernels.launches()} "
                  f"!= {want}")
        err = (engines["cpu"][1] - engines["cuda"][1]).abs().max().item()
        check(err <= 1e-4, f"[parity {name}] f32 first-step logits card vs "
                           f"CPU: {err} > 1e-4")
        check(outs["cpu"] == outs["cuda"],
              f"[parity {name}] greedy streams differ: cpu {outs['cpu']} "
              f"cuda {outs['cuda']}")
        check(engines["cuda"][0].stats["decode_backend"] == "kernel",
              "card engine did not take the kernel path")
        eng = engines["cuda"][0]
        log(f"[parity f32, TF32 off] {name} (paged={eng.paged}, "
            f"mixed={eng.mixed}): first-step logits max abs err card vs "
            f"CPU {err:.3e} (<= 1e-4); greedy streams identical over "
            f"{len(prompts)} requests")
        errs[name] = err
    return errs


#: phase 4's prefix, lazy and scheduler runs: name -> engine keywords.
#: The traffic (``_prefix_traffic``) shares a 24-token system prompt; its
#: second wave opens with the first 28 tokens of wave 1's last prompt,
#: which end inside a block registered from that prompt's decode (a
#: partial-tail hit, so a copy-on-write under lazy); the lazy pool of 8
#: pages of 8 tokens is below the first wave's demand (preemptions).
PREFIX_RUNS = {
    "prefix off": dict(),
    "prefix on": dict(prefix_cache=True),
    "lazy, pool below demand": dict(prefix_cache=True, lazy=True,
                                    kv_pages=8),
    "Priority()": dict(prefix_cache=True, lazy=True, kv_pages=8,
                       scheduler="Priority"),
}
#: the counters that must equal the CPU run's (host logic)
PREFIX_COUNTERS = ("prefix_hit_blocks", "prefix_miss_blocks",
                   "prefix_tail_hits", "prefix_evictions", "preemptions",
                   "cow_copies")


def _prefix_traffic(eng, vocab: int, seed: int = 11):
    """Two waves through ``eng``, 10 new tokens a request: five prompts
    opening with one 24-token system prompt (priorities 1, 3, 0, 2, -1:
    ``Priority()`` admits them out of order, the last one last), run to
    the end; then three more, the first repeating 28 tokens of wave 1's
    last prompt. Returns the streams."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, size=(24,)).astype(np.int32)
    wave1 = [np.concatenate([system, rng.integers(0, vocab, size=(n,))])
             .astype(np.int32) for n in (5, 9, 3, 14, 7)]
    wave2 = [wave1[4][:28]] + [
        np.concatenate([system, rng.integers(0, vocab, size=(n,))])
        .astype(np.int32) for n in (11, 4)]
    for rid, (p, pri) in enumerate(zip(wave1, (1, 3, 0, 2, -1))):
        eng.submit(rid, p, max_new=10, priority=pri)
    eng.run()
    for rid, p in enumerate(wave2, len(wave1)):
        eng.submit(rid, p, max_new=10, priority=rid % 3)
    res = eng.run()
    return {i: list(res[i].out) for i in sorted(res)}


def phase_parity_prefix():
    """The tiny f32 dense config (TF32 off), card vs CPU, through
    ``_prefix_traffic`` with each of ``PREFIX_RUNS`` on the mixed path
    and on the split path (``mixed=False``): greedy streams identical,
    every counter of ``PREFIX_COUNTERS`` equal to the CPU run's, every
    stream equal to the prefix-off run's, pages all back after
    ``release_prefix_cache()``, and the lazy runs show at least one
    preemption and one copy-on-write. Returns the counters of each run."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.params import init_params
    from repro_torch.serve import scheduler
    from repro_torch.serve.engine import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="pal-dense", arch_type="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=128, dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=3)
    weights = {"cpu": cpu, "cuda": _to(cpu, "cuda")}
    out, base = {}, {}
    for mixed in (True, False):
        for name, kw in PREFIX_RUNS.items():
            kw = dict(kw)
            if "scheduler" in kw:
                kw["scheduler"] = getattr(scheduler, kw["scheduler"])()
            runs = {}
            for dev, params in weights.items():
                eng = ServeEngine(cfg, params, slots=3, max_len=64,
                                  page_size=8, mixed=mixed, chunk_tokens=16,
                                  **kw)
                streams = _prefix_traffic(eng, cfg.vocab_size)
                eng.release_prefix_cache()
                check(eng.stats["pages_in_use"] == 0,
                      f"[parity prefix {name}] {eng.stats['pages_in_use']} "
                      f"pages left on {dev}")
                runs[dev] = (streams, {k: eng.stats[k]
                                       for k in PREFIX_COUNTERS})
            path = "mixed" if mixed else "split"
            check(runs["cpu"][0] == runs["cuda"][0],
                  f"[parity prefix {path}, {name}] greedy streams card vs "
                  f"CPU differ")
            check(runs["cpu"][1] == runs["cuda"][1],
                  f"[parity prefix {path}, {name}] counters card "
                  f"{runs['cuda'][1]} != CPU {runs['cpu'][1]}")
            base.setdefault(mixed, runs["cuda"][0])
            check(runs["cuda"][0] == base[mixed],
                  f"[parity prefix {path}, {name}] streams differ from the "
                  f"prefix-off run's")
            if kw.get("lazy"):
                c = runs["cuda"][1]
                check(c["preemptions"] >= 1 and c["cow_copies"] >= 1,
                      f"[parity prefix {path}, {name}] lazy run without a "
                      f"preemption and a copy-on-write: {c}")
            log(f"[parity prefix f32] {path}, {name}: streams card = CPU = "
                f"prefix off; counters card = CPU {runs['cuda'][1]}")
            out[f"{path}, {name}"] = runs["cuda"][1]
    return out


def phase_parity_spec():
    """The tiny f32 dense config (TF32 off), card vs CPU, through the
    mixed step with speculative decode (k 4, the ngram drafter) on
    repetitive prompts (motifs of 3-6 tokens tiled to 20-40): streams
    identical on card and CPU and to the card's spec-off run, drafted,
    accepted and program-shape counters equal to the CPU's, both above 0,
    and the card's launches the mixed step's. Returns the card's
    counters."""
    from repro_torch import kernels
    from repro_torch.configs.base import ModelConfig
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.speculative import SpecConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="pal-dense", arch_type="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=128, dtype="float32")
    rng = np.random.default_rng(19)
    prompts = [np.resize(rng.integers(0, 128, size=(int(rng.integers(3, 7)),)),
                         int(rng.integers(20, 41))).astype(np.int32)
               for _ in range(4)]
    cpu = init_params(cfg, device="cpu", seed=3)
    keys = ("spec_drafted", "spec_accepted", "decode_steps",
            "decode_traces", "decode_tokens")
    runs = {}
    for dev, params, spec in (("cpu", cpu, SpecConfig(k=4)),
                              ("cuda", _to(cpu, "cuda"), SpecConfig(k=4)),
                              ("cuda off", None, None)):
        if params is None:
            params = _to(cpu, "cuda")
        eng = ServeEngine(cfg, params, slots=2, max_len=64, chunk_tokens=16,
                          spec=spec)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=12)
        kernels.reset_launches()
        res = eng.run()
        counts = kernels.launches()
        want = _want_launches(eng, cfg.num_layers) if dev != "cpu" \
            else dict.fromkeys(counts, 0)
        check(counts == want, f"[parity spec] launches on {dev} {counts} "
              f"!= {want}")
        runs[dev] = ({i: list(res[i].out) for i in res},
                     {k: eng.stats[k] for k in keys})
    check(runs["cpu"][0] == runs["cuda"][0] == runs["cuda off"][0],
          "[parity spec] f32 greedy streams differ between the card with "
          "spec, the CPU with spec and the card without")
    check(runs["cpu"][1] == runs["cuda"][1], f"[parity spec] counters card "
          f"{runs['cuda'][1]} != CPU {runs['cpu'][1]}")
    st = runs["cuda"][1]
    check(st["spec_drafted"] > 0 and st["spec_accepted"] > 0,
          f"[parity spec] drafted {st['spec_drafted']}, accepted "
          f"{st['spec_accepted']}: each must be > 0")
    check(st["decode_traces"] == runs["cuda off"][1]["decode_traces"],
          "[parity spec] program shapes differ spec on vs off")
    log(f"[parity f32 spec, TF32 off] k 4, ngram: streams card = CPU = "
        f"spec off over {len(prompts)} repetitive prompts; drafted "
        f"{st['spec_drafted']}, accepted {st['spec_accepted']}, "
        f"{st['decode_steps']} decode steps against "
        f"{runs['cuda off'][1]['decode_steps']} without (card = CPU)")
    return {"card": st, "spec_off": runs["cuda off"][1]}


def phase_parity_ssm():
    """mamba2-smoke in fp32 (TF32 off) through the port's split-path
    engine on the card and on the CPU: the first prefill's logits within
    1e-4 (a first request with max_new 1 finishes on its prefill, so the
    engine's last program is that prefill), then every greedy stream
    identical. Prompts satisfy the chunk precondition (<= 32 or a multiple
    of 32) and include two- and three-chunk prefills."""
    from repro_torch import kernels
    from repro_torch.configs import get_smoke
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke("mamba2-780m").with_(dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=7)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (64, 17, 32, 96, 9)]
    res, first = {}, {}
    for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
        eng = ServeEngine(cfg, params, slots=2, max_len=160)
        kernels.reset_launches()
        eng.submit(0, prompts[0], max_new=1)
        eng.step()
        first[dev] = eng.last_logits.detach().float().cpu()
        for i, p in enumerate(prompts[1:], 1):
            eng.submit(i, p, max_new=6)
        out = eng.run()
        res[dev] = {i: list(out[i].out) for i in out}
        want = cfg.num_layers * eng.stats["prefills"] if dev == "cuda" else 0
        check(kernels.launches()["ssd_scan"] == want,
              f"ssm parity on {dev}: {kernels.launches()} (ssd_scan "
              f"{want} = layers x prefills)")
    err = (first["cpu"] - first["cuda"]).abs().max().item()
    check(first["cpu"].shape == (1, 1, cfg.vocab_size),
          f"first prefill logits shape {tuple(first['cpu'].shape)}")
    check(err <= 1e-4, f"ssm f32 first-prefill logits card vs CPU: "
                       f"{err} > 1e-4")
    check(res["cpu"] == res["cuda"],
          f"ssm greedy streams differ: cpu {res['cpu']} cuda {res['cuda']}")
    log(f"[parity ssm f32, TF32 off] mamba2-smoke first-prefill logits max "
        f"abs err card vs CPU {err:.3e} (<= 1e-4); greedy streams identical "
        f"over {len(prompts)} requests")
    return err


def phase_train_parity():
    """One fp32 train step (remat on, attn_impl="auto": the flash kernel
    on the card, full attention on the CPU) on both devices: loss and
    gradients within 1e-4, TF32 off."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.strategy import Strategy
    from repro_torch.params import init_params
    from repro_torch.train import step
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(name="pal-dense", arch_type="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=128, dtype="float32", qk_norm=True)
    strat = Strategy(dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=5)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, 128, size=(2, 160)).astype(np.int32))
    res = {}
    for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
        leaves = flatten(params)
        for t in leaves.values():
            t.requires_grad_(True)
        total, mets = step.make_loss_fn(cfg, strat)(
            params, {"tokens": tokens.to(dev)})
        grads = torch.autograd.grad(total, list(leaves.values()))
        res[dev] = (float(mets["loss"].detach()),
                    {k: g.cpu() for k, g in zip(leaves, grads)})
    loss_err = abs(res["cpu"][0] - res["cuda"][0])
    grad_err = max((res["cuda"][1][k] - g).abs().max().item()
                   for k, g in res["cpu"][1].items())
    check(loss_err <= 1e-4, f"f32 train loss card vs CPU: {loss_err} > 1e-4")
    check(grad_err <= 1e-4, f"f32 train grads card vs CPU: {grad_err} > 1e-4")
    log(f"[parity f32 train step, TF32 off] loss {res['cpu'][0]:.6f}: card "
        f"vs CPU err {loss_err:.3e}, grads max abs err {grad_err:.3e} "
        f"(<= 1e-4)")
    return {"loss_err": loss_err, "grad_err": grad_err}


#: phase 4's hybrid configs: zamba2-smoke (one group, rest 0), a rest > 0
#: variant (one trailing Mamba layer) and a sliding-window variant (the
#: ring of 16 rows wraps)
HYBRID_PARITY = {"rest 0": {},
                 "rest 1": dict(num_layers=3, hybrid_attn_every=2),
                 "swa 16": dict(sliding_window=16)}


def phase_parity_hybrid():
    """zamba2-smoke and its two variants in fp32 (TF32 off) through the
    split-path engine on the card and on the CPU: the first prefill's
    logits within 1e-4 (a first request with max_new 1), then every
    greedy stream identical; on the card the SSD kernel ran layers x
    prefills, flash G x prefills and the fused MLP G x programs. Returns
    the first-prefill error of each config."""
    from repro_torch import kernels
    from repro_torch.configs import get_smoke
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for name, kw in HYBRID_PARITY.items():
        cfg = get_smoke("zamba2-1.2b").with_(dtype="float32", **kw)
        g = cfg.num_layers // cfg.hybrid_attn_every
        cpu = init_params(cfg, device="cpu", seed=7)
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
                   for n in (64, 17, 32, 96, 9)]
        res, first = {}, {}
        for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
            eng = ServeEngine(cfg, params, slots=2, max_len=160)
            kernels.reset_launches()
            eng.submit(0, prompts[0], max_new=1)
            eng.step()
            first[dev] = eng.last_logits.detach().float().cpu()
            for i, p in enumerate(prompts[1:], 1):
                eng.submit(i, p, max_new=6)
            out = eng.run()
            res[dev] = {i: list(out[i].out) for i in out}
            pf, dec = eng.stats["prefills"], eng.stats["decode_steps"]
            on = dev == "cuda"
            want = {"paged_attention": 0,
                    "fused_mlp": g * (pf + dec) if on else 0,
                    "flash_attention": g * pf if on else 0,
                    "ssd_scan": cfg.num_layers * pf if on else 0}
            check(kernels.launches() == want,
                  f"[parity hybrid {name}] launches on {dev} "
                  f"{kernels.launches()} != {want}")
        err = (first["cpu"] - first["cuda"]).abs().max().item()
        check(err <= 1e-4, f"[parity hybrid {name}] f32 first-prefill "
                           f"logits card vs CPU: {err} > 1e-4")
        check(res["cpu"] == res["cuda"],
              f"[parity hybrid {name}] greedy streams differ: cpu "
              f"{res['cpu']} cuda {res['cuda']}")
        log(f"[parity hybrid f32, TF32 off] zamba2-smoke {name}: "
            f"first-prefill logits max abs err card vs CPU {err:.3e} (<= "
            f"1e-4); greedy streams identical over {len(prompts)} requests")
        errs[name] = err
    return errs


def phase_train_parity_families():
    """One fp32 train step (remat on, attn_impl="auto": flash on the card
    in the hybrid's shared block, full attention on the CPU; the plain SSD
    scan on both) on mamba2-smoke and zamba2-smoke: loss and gradients
    within 1e-4, TF32 off."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.strategy import Strategy
    from repro_torch.params import init_params
    from repro_torch.train import step
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    strat = Strategy(dtype="float32")
    out = {}
    for arch in ("mamba2-780m", "zamba2-1.2b"):
        cfg = get_smoke(arch).with_(dtype="float32")
        cpu = init_params(cfg, device="cpu", seed=5)
        tokens = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, size=(2, 128)).astype(np.int32))
        res = {}
        for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
            leaves = flatten(params)
            for t in leaves.values():
                t.requires_grad_(True)
            total, mets = step.make_loss_fn(cfg, strat)(
                params, {"tokens": tokens.to(dev)})
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        materialize_grads=True)
            res[dev] = (float(mets["loss"].detach()),
                        {k: g.cpu() for k, g in zip(leaves, grads)})
        loss_err = abs(res["cpu"][0] - res["cuda"][0])
        grad_err = max((res["cuda"][1][k] - g).abs().max().item()
                       for k, g in res["cpu"][1].items())
        check(loss_err <= 1e-4 and grad_err <= 1e-4,
              f"{cfg.name} f32 train step card vs CPU: loss err {loss_err}, "
              f"grads max abs err {grad_err} (limit 1e-4)")
        log(f"[parity f32 train step, TF32 off] {cfg.name} loss "
            f"{res['cpu'][0]:.6f}: card vs CPU err {loss_err:.3e}, grads max "
            f"abs err {grad_err:.3e} (<= 1e-4)")
        out[cfg.name] = {"loss_err": loss_err, "grad_err": grad_err}
    return out


#: phase 4's MoE layouts for olmoe-smoke at capacity factor 2.0 (E / k:
#: no-drop routing, the reference serving tests' setting): the mixed step,
#: the split path on the pool and on the dense layout
MOE_PARITY_LAYOUTS = {"mixed": dict(chunk_tokens=16),
                      "split": dict(mixed=False),
                      "dense": dict(paged=False)}


def _moe_want(eng, layers: int) -> dict:
    """An MoE run's launches on the card: as ``_want_launches`` says, but
    the fused MLP never (the experts are batched matmuls)."""
    return dict(_want_launches(eng, layers), fused_mlp=0)


def phase_parity_moe():
    """olmoe-smoke in fp32 at capacity factor 2.0 (TF32 off) through the
    port's engine on the card and on the CPU, on each of
    ``MOE_PARITY_LAYOUTS``: first-step logits within 1e-4, greedy streams
    identical, and on the card paged attention, flash and the fused MLP
    launched as ``_moe_want`` says; then one MoE train step (remat on,
    flash on the card): loss, aux loss and gradients within 1e-4. Returns
    the errors."""
    from repro_torch import kernels
    from repro_torch.configs import get_smoke
    from repro_torch.core.strategy import Strategy
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke("olmoe-1b-7b").with_(dtype="float32",
                                         moe_capacity_factor=2.0)
    cpu = init_params(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (5, 23, 9, 40, 6)]
    errs = {}
    for name, eng_kw in MOE_PARITY_LAYOUTS.items():
        first, outs = {}, {}
        for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
            eng = ServeEngine(cfg, params, slots=2, max_len=64, **eng_kw)
            for i, p in enumerate(prompts):
                eng.submit(i, p, max_new=6)
            kernels.reset_launches()
            eng.step()
            first[dev] = eng.last_logits.detach().float().cpu()
            res = eng.run()
            outs[dev] = {i: list(res[i].out) for i in res}
            want = _moe_want(eng, cfg.num_layers) if dev == "cuda" \
                else dict.fromkeys(kernels.launches(), 0)
            check(kernels.launches() == want,
                  f"[parity moe {name}] launches on {dev} "
                  f"{kernels.launches()} != {want}")
        err = (first["cpu"] - first["cuda"]).abs().max().item()
        check(err <= 1e-4, f"[parity moe {name}] f32 first-step logits card "
                           f"vs CPU: {err} > 1e-4")
        check(outs["cpu"] == outs["cuda"],
              f"[parity moe {name}] greedy streams differ: cpu "
              f"{outs['cpu']} cuda {outs['cuda']}")
        log(f"[parity moe f32, TF32 off] olmoe-smoke cf 2.0, {name} "
            f"(paged={eng.paged}, mixed={eng.mixed}): first-step logits max "
            f"abs err card vs CPU {err:.3e} (<= 1e-4); greedy streams "
            f"identical over {len(prompts)} requests")
        errs[name] = err
    strat = Strategy(dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, 160)).astype(np.int32))
    res = {}
    for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
        leaves = flatten(params)
        for t in leaves.values():
            t.requires_grad_(True)
        kernels.reset_launches()
        total, mets = step.make_loss_fn(cfg, strat)(
            params, {"tokens": tokens.to(dev)})
        grads = torch.autograd.grad(total, list(leaves.values()))
        flash = kernels.launches()["flash_attention"]
        check(flash == (cfg.num_layers * 2 if dev == "cuda" else 0),
              f"[parity moe train] flash launches on {dev}: {flash}")
        res[dev] = (float(mets["loss"].detach()),
                    float(mets["aux_loss"].detach()),
                    {k: g.cpu() for k, g in zip(leaves, grads)})
    loss_err = abs(res["cpu"][0] - res["cuda"][0])
    aux_err = abs(res["cpu"][1] - res["cuda"][1])
    grad_err = max((res["cuda"][2][k] - g).abs().max().item()
                   for k, g in res["cpu"][2].items())
    check(loss_err <= 1e-4 and aux_err <= 1e-4 and grad_err <= 1e-4,
          f"olmoe-smoke f32 train step card vs CPU: loss err {loss_err}, "
          f"aux err {aux_err}, grads max abs err {grad_err} (limit 1e-4)")
    log(f"[parity moe f32 train step, TF32 off] olmoe-smoke loss "
        f"{res['cpu'][0]:.6f}, aux {res['cpu'][1]:.6f}: card vs CPU loss err "
        f"{loss_err:.3e}, aux err {aux_err:.3e}, grads max abs err "
        f"{grad_err:.3e} (<= 1e-4)")
    errs["train"] = {"loss_err": loss_err, "aux_err": aux_err,
                     "grad_err": grad_err}
    return errs


def _audio_want(eng, cfg) -> dict:
    """An enc-dec run's launches on the card: paged attention once a
    decoder layer a program (the mixed step) or a decode step (the split
    path on the pool); flash once an encoder layer an admission (the
    mixed step's encode program) or once an encoder and a decoder layer a
    split prefill; the fused MLP never (plain GeLU)."""
    st = eng.stats
    if eng.mixed:
        return {"paged_attention": cfg.num_layers * st["mixed_steps"],
                "fused_mlp": 0, "ssd_scan": 0,
                "flash_attention": cfg.encoder_layers * st["prefills"]}
    return {"paged_attention": cfg.num_layers * st["decode_steps"]
            if eng.paged else 0, "fused_mlp": 0, "ssd_scan": 0,
            "flash_attention": (cfg.encoder_layers + cfg.num_layers)
            * st["prefills"]}


def phase_parity_audio():
    """whisper-smoke in fp32 (TF32 off) through the port's engine on the
    card and on the CPU, on the mixed step (chunk 16), the split path on
    the pool and the dense layout: first-step logits within 1e-4, greedy
    streams identical, and on the card each kernel launched as
    ``_audio_want`` says (one encode shape on the mixed step); then one
    train step (remat on, 2 microbatches, each slicing tokens and frames;
    flash on the card): loss and gradients within 1e-4. Returns the
    errors."""
    from repro_torch import kernels
    from repro_torch.configs import get_smoke
    from repro_torch.core.strategy import Strategy
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke("whisper-tiny").with_(dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (5, 23, 9, 40, 6)]
    frames = list(rng.standard_normal((len(prompts), cfg.encoder_ctx,
                                       cfg.d_model), dtype=np.float32))
    errs = {}
    for name, eng_kw in MOE_PARITY_LAYOUTS.items():
        first, outs = {}, {}
        for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
            eng = ServeEngine(cfg, params, slots=2, max_len=64, **eng_kw)
            for i, (p, f) in enumerate(zip(prompts, frames)):
                eng.submit(i, p, max_new=6, frames=f)
            kernels.reset_launches()
            eng.step()
            first[dev] = eng.last_logits.detach().float().cpu()
            res = eng.run()
            outs[dev] = {i: list(res[i].out) for i in res}
            want = _audio_want(eng, cfg) if dev == "cuda" \
                else dict.fromkeys(kernels.launches(), 0)
            check(kernels.launches() == want,
                  f"[parity audio {name}] launches on {dev} "
                  f"{kernels.launches()} != {want}")
            check(eng.stats["encode_traces"] == int(eng.mixed),
                  f"[parity audio {name}] encode_traces "
                  f"{eng.stats['encode_traces']}")
        err = (first["cpu"] - first["cuda"]).abs().max().item()
        check(err <= 1e-4, f"[parity audio {name}] f32 first-step logits "
                           f"card vs CPU: {err} > 1e-4")
        check(outs["cpu"] == outs["cuda"],
              f"[parity audio {name}] greedy streams differ: cpu "
              f"{outs['cpu']} cuda {outs['cuda']}")
        log(f"[parity audio f32, TF32 off] whisper-smoke, {name} "
            f"(paged={eng.paged}, mixed={eng.mixed}): first-step logits max "
            f"abs err card vs CPU {err:.3e} (<= 1e-4); greedy streams "
            f"identical over {len(prompts)} requests")
        errs[name] = err
    strat = Strategy(remat=True, microbatches=2, dtype="float32")
    brng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(brng.integers(
        0, cfg.vocab_size, size=(4, 48)).astype(np.int32)),
        "frames": torch.from_numpy(brng.standard_normal(
            (4, cfg.encoder_ctx, cfg.d_model), dtype=np.float32))}
    res = {}
    for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
        leaves = flatten(params)
        for t in leaves.values():
            t.requires_grad_(True)
        kernels.reset_launches()
        loss_fn = step.make_loss_fn(cfg, strat)
        losses, grads = [], None
        for i in (0, 2):          # the train step's two microbatches
            total, mets = loss_fn(params, {k: v[i:i + 2].to(dev)
                                           for k, v in batch.items()})
            g = torch.autograd.grad(total, list(leaves.values()))
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            losses.append(float(mets["loss"].detach()))
        flash = kernels.launches()["flash_attention"]
        want = 2 * (cfg.encoder_layers + 2 * cfg.num_layers)
        check(flash == (want if dev == "cuda" else 0),
              f"[parity audio train] flash launches on {dev}: {flash}")
        res[dev] = (losses, {k: (g / 2).cpu() for k, g in zip(leaves,
                                                               grads)})
    loss_err = max(abs(a - b) for a, b in zip(res["cpu"][0], res["cuda"][0]))
    grad_err = max((res["cuda"][1][k] - g).abs().max().item()
                   for k, g in res["cpu"][1].items())
    check(loss_err <= 1e-4 and grad_err <= 1e-4,
          f"whisper-smoke f32 train step card vs CPU: loss err {loss_err}, "
          f"grads max abs err {grad_err} (limit 1e-4)")
    log(f"[parity audio f32 train step, TF32 off] whisper-smoke, remat, 2 "
        f"microbatches, losses {[round(x, 6) for x in res['cpu'][0]]}: card "
        f"vs CPU loss err {loss_err:.3e}, grads max abs err {grad_err:.3e} "
        f"(<= 1e-4)")
    errs["train"] = {"loss_err": loss_err, "grad_err": grad_err}
    return errs


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# ------------------------------------------------------------------ phase 5

def serving_prompts(seed: int, vocab: int):
    """Phase 5's six requests (phases 13 and 13b serve them too): lengths
    of 24-700 tokens, one of them over 512 (more than two 256-row
    chunks), drawn from ``seed``; then each prompt's tokens below
    ``vocab``. Returns (lengths, prompts)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(24, 701, size=6)
    lens[int(rng.integers(6))] = int(rng.integers(513, 701))  # > 2 chunks
    return lens, [rng.integers(0, vocab, size=(int(n),)) for n in lens]


#: the depth at which phases 5-10 and 20 serve Qwen3-14B at full width
#: (16 of its 40 layers: the script's time limit; uncut until phases
#: 32-33)
MAIN_LAYERS = 16


def phase_main(seed: int):
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.serve.paging import pages_for
    from repro_torch.serve.step import page_bucket
    cfg = get_config("qwen3-14b").with_(num_layers=MAIN_LAYERS)
    log(f"[main] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{cfg.param_count() / 1e9:.2f} B params")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = Session(cfg, device="cuda", seed=seed)
    eng = session.serve(slots=4, max_len=1024, page_size=16,
                        chunk_tokens=256)
    torch.cuda.synchronize()
    log(f"[main] weights + pool ready in {time.perf_counter() - t0:.1f}s "
        f"(kv pool {eng.kv_bytes() / 1e9:.2f} GB)")
    lens, prompts = serving_prompts(seed, cfg.vocab_size)
    max_new = 16
    for rid, prompt in enumerate(prompts):
        eng.submit(rid, prompt, max_new=max_new)
    buckets = {page_bucket(max(pages_for(min(int(n) + max_new - 1, 1024), 16)
                               for n in lens[:i + 1]), cap=64)
               for i in range(len(lens))}
    serving = ("paged_attention", "fused_mlp")
    kernels.reset_launches()
    step_s, prefill_step = [], []
    t0 = time.perf_counter()
    while eng.busy():
        s0 = time.perf_counter()
        chunk0 = eng.stats["prefill_chunk_tokens"]
        eng.step()
        step_s.append(time.perf_counter() - s0)
        prefill_step.append(eng.stats["prefill_chunk_tokens"] > chunk0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    res = eng.results()
    runs = eng.stats["mixed_steps"]
    for rid in range(len(lens)):
        r = res[rid]
        check(r.done and len(r.out) == max_new,
              f"request {rid} finished={r.done} with {len(r.out)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out),
              f"request {rid} tokens out of range")
    for name, n in counts.items():
        want = cfg.num_layers * runs if name in serving else 0
        check(n == want, f"{name}: {n} launches != {want} "
                         f"({cfg.num_layers} layers x {runs} program runs "
                         f"for the serving kernels, 0 for the others)")
    check(eng.stats["decode_traces"] <= len(buckets),
          f"{eng.stats['decode_traces']} program shapes > {len(buckets)} "
          f"page buckets")
    check(bool(torch.isfinite(eng.last_logits).all()), "finite logits")
    tokens = sum(len(res[r].out) for r in res)
    step_ms = np.asarray(step_s) * 1e3
    with_pf = np.asarray(prefill_step)
    out = {"layers": cfg.num_layers, "prompt_lens": [int(n) for n in lens],
           "max_new": max_new, "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall, "program_runs": runs,
           "step_p50_ms": float(np.percentile(step_ms, 50)),
           "step_max_ms": float(step_ms.max()),
           "prefill_steps": int(with_pf.sum()),
           "prefill_step_p50_ms": float(np.percentile(step_ms[with_pf], 50)),
           "decode_only_step_p50_ms": float(
               np.percentile(step_ms[~with_pf], 50)),
           "prefill_tokens": int(sum(lens)),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decode_traces": eng.stats["decode_traces"],
           "launches": counts, "kv_bytes": eng.kv_bytes(),
           "streams": [list(res[rid].out) for rid in range(len(lens))]}
    log(f"[main] {len(lens)} requests (prompts {out['prompt_lens']}), "
        f"{tokens} tokens in {wall:.2f}s = {out['tokens_per_s']:.2f} tok/s; "
        f"{runs} program runs, step p50 {out['step_p50_ms']:.1f} ms (with "
        f"prefill rows {out['prefill_step_p50_ms']:.1f} ms over "
        f"{out['prefill_steps']} steps, decode only "
        f"{out['decode_only_step_p50_ms']:.1f} ms), max "
        f"{out['step_max_ms']:.1f} ms; peak memory "
        f"{out['peak_mem_gb']:.2f} GB; launches {counts}; "
        f"{eng.stats['decode_traces']} program shape(s)")
    return out, eng, session, prompts


# ----------------------------------------------------------------- phase 5b

def phase_split(session, prompts, streams, seed: int, max_new: int = 16):
    """The SPLIT SERVING PATH at full width, on phase 5's session (its
    weights; phase 5's pool is freed first): phase 5's prompts, 16 new
    tokens each, through ``session.serve(paged=False, mixed=False)`` (the
    dense per-slot layout) and ``session.serve(mixed=False)`` (the paged
    split path), 4 slots x 1024 tokens, then one ``session.generate`` of a
    (4, 512) prompt for 16 steps. Counts are zeroed just before and read
    just after each: flash attention once a layer a prefill, the fused MLP
    once a layer a program, paged attention once a layer a decode on the
    pool and never on the dense layout. Every request must finish with 16
    in-vocab tokens. The share of tokens equal to phase 5's mixed-engine
    streams is information only: in bf16 the split path prefills through
    flash (P fp32) and the mixed step through paged attention, and the
    fused MLP's split-K plan depends on the row count. Then one more pair
    of requests (600 and 40 tokens, 4 new each) runs under
    ``torch.profiler``, its admission step and its decode-only steps
    apart."""
    from repro_torch import kernels
    from repro_torch.serve.step import prefill_bucket
    cfg = session.cfg
    layers = cfg.num_layers
    buckets = {prefill_bucket(len(p), cap=1024) for p in prompts}
    out = {}
    for name, kw in (("dense", dict(paged=False, mixed=False)),
                     ("paged split", dict(mixed=False))):
        torch.cuda.reset_peak_memory_stats()
        eng = session.serve(slots=4, max_len=1024, page_size=16, **kw)
        for rid, p in enumerate(prompts):
            eng.submit(rid, p, max_new=max_new)
        kernels.reset_launches()
        step_s, prefill_step = [], []
        t0 = time.perf_counter()
        while eng.busy():
            s0 = time.perf_counter()
            pf0 = eng.stats["prefills"]
            eng.step()
            step_s.append(time.perf_counter() - s0)
            prefill_step.append(eng.stats["prefills"] > pf0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        res = eng.results()
        for rid in range(len(prompts)):
            r = res[rid]
            check(r.done and len(r.out) == max_new,
                  f"[split {name}] request {rid} finished={r.done} with "
                  f"{len(r.out)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in r.out),
                  f"[split {name}] request {rid} tokens out of range")
        want = _want_launches(eng, layers)
        check(counts == want, f"[split {name}] launches {counts} != {want} "
                              f"({layers} layers x prefills / programs / "
                              f"decodes)")
        check(eng.stats["prefill_traces"] == len(buckets),
              f"[split {name}] prefill_traces "
              f"{eng.stats['prefill_traces']} != {len(buckets)} buckets")
        check(eng.stats["decode_traces"] == 1,
              f"[split {name}] decode_traces {eng.stats['decode_traces']}")
        check(bool(torch.isfinite(eng.last_logits).all()),
              f"[split {name}] finite logits")
        got = [list(res[rid].out) for rid in range(len(prompts))]
        agree = sum(a == b for g, w in zip(got, streams)
                    for a, b in zip(g, w)) / (max_new * len(prompts))
        # the index of each request's first token unequal to phase 5's
        first_diff = [next((i for i, (a, b) in enumerate(zip(g, w))
                            if a != b), max_new)
                      for g, w in zip(got, streams)]
        tokens = sum(len(g) for g in got)
        step_ms = np.asarray(step_s) * 1e3
        with_pf = np.asarray(prefill_step)
        run = {"paged": eng.paged, "tokens": tokens, "wall_s": wall,
               "tokens_per_s": tokens / wall, "steps": len(step_s),
               "prefills": eng.stats["prefills"],
               "decode_steps": eng.stats["decode_steps"],
               "step_p50_ms": float(np.percentile(step_ms, 50)),
               "prefill_steps": int(with_pf.sum()),
               "prefill_step_p50_ms": float(
                   np.percentile(step_ms[with_pf], 50)),
               "decode_only_step_p50_ms": float(
                   np.percentile(step_ms[~with_pf], 50)),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "kv_gb": eng.kv_bytes() / 1e9,
               "prefill_traces": eng.stats["prefill_traces"],
               "decode_traces": eng.stats["decode_traces"],
               "launches": counts, "agree_with_mixed": agree,
               "first_diff_with_mixed": first_diff,
               "streams": got}
        log(f"[split {name}] {len(prompts)} requests, {tokens} tokens in "
            f"{wall:.2f}s = {run['tokens_per_s']:.2f} tok/s; "
            f"{run['steps']} steps, step p50 {run['step_p50_ms']:.1f} ms "
            f"(with prefills {run['prefill_step_p50_ms']:.1f} ms over "
            f"{run['prefill_steps']} steps, decode only "
            f"{run['decode_only_step_p50_ms']:.1f} ms); peak memory "
            f"{run['peak_mem_gb']:.2f} GB (KV {run['kv_gb']:.2f} GB); "
            f"launches {counts}; prefill_traces {run['prefill_traces']}, "
            f"decode_traces {run['decode_traces']}; {agree:.1%} of tokens "
            f"equal to phase 5's mixed-engine streams, first unequal token "
            f"of each request at {first_diff} (information)")
        # one more pair (600 and 40 tokens, 4 new each): its admission
        # step (two prefills and a decode) and its decode-only steps under
        # the profiler apart, each against the unprofiled p50 of its kind
        pooled = ("paged_attention",) if eng.paged else ()
        run["profile"] = phase_profile(
            eng, np.random.default_rng(seed), run["prefill_step_p50_ms"],
            groups=SPLIT_GROUPS, tag=f"split {name} profile: admission step",
            steps=1, required=("flash_attention", "fused_mlp") + pooled)
        run["profile_decode"] = _profile_steps(
            eng, run["decode_only_step_p50_ms"], SPLIT_GROUPS,
            f"split {name} profile: decode-only steps",
            required=("fused_mlp",) + pooled)
        out[name] = run
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    # the lockstep generate loop: one (4, 512) prefill, 15 decodes
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, cfg.vocab_size, size=(4, 512)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    toks = session.generate(prompt, steps=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    want = {"paged_attention": 0, "fused_mlp": layers * max_new,
            "flash_attention": layers, "ssd_scan": 0}
    check(counts == want, f"[generate] launches {counts} != {want}")
    check(tuple(toks.shape) == (4, max_new) and toks.is_cuda,
          f"[generate] tokens {tuple(toks.shape)} on {toks.device}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "[generate] tokens out of range")
    out["generate"] = {"prompt": [4, 512], "steps": max_new, "wall_s": wall,
                       "tokens_per_s": toks.numel() / wall,
                       "peak_mem_gb": torch.cuda.max_memory_allocated()
                       / 1e9, "launches": counts}
    log(f"[generate] (4, 512) prompt, {max_new} steps: {toks.numel()} "
        f"tokens in {wall:.2f}s = {out['generate']['tokens_per_s']:.2f} "
        f"tok/s (prefill included); peak memory "
        f"{out['generate']['peak_mem_gb']:.2f} GB; launches {counts}")
    return out


#: phase 5's kernel groups: name -> substrings of the device kernel's name
#: (csrc/: the bf16 fused MLP is mlp_tma_wgmma_kernel, twice, with
#: mlp_tail_sum_kernel and mlp_split_sum_kernel; gemm_f32 is its fp32 pair;
#: bf16 paged attention is PAGED_LAUNCHES, paged_attention_kernel its fp32
#: entry)
SERVE_GROUPS = {"paged_attention": ("paged_attention_kernel",
                                    *PAGED_LAUNCHES),
                "fused_mlp": ("mlp_tma_wgmma_kernel", "mlp_tail_sum_kernel",
                              "mlp_split_sum_kernel", "gemm_f32")}
#: phase 5b's kernel groups: phase 5's, flash attention (every split
#: prefill) and the softmax of the plain decode attention (dense layout)
SPLIT_GROUPS = {**SERVE_GROUPS, "flash_attention": ("flash_fwd",),
                "softmax": ("softmax",)}


def phase_profile(eng, rng, step_p50_ms: float, *, prompts=(600, 40),
                  max_new: int = 4, groups=SERVE_GROUPS, tag="profile",
                  steps=None, required=tuple(SERVE_GROUPS)):
    """Where the time goes: a serving engine under torch.profiler for one
    more pair of requests (phase 5: a 600-token prompt, so three 256-row
    chunks, and a 40-token one; 4 new tokens each), over its next
    ``steps`` steps (None: until it is idle). The profiler's one-time
    start-up is paid in a warm-up session before the window, to keep its
    host cost out. Fails if a ``required`` group matched no device
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    for rid, n in enumerate(prompts):
        eng.submit(100 + rid, rng.integers(0, eng.cfg.vocab_size, size=n),
                   max_new=max_new)
    return _profile_steps(eng, step_p50_ms, groups, tag, steps, required)


def _profile_steps(eng, step_p50_ms: float, groups, tag: str, steps=None,
                   required=()):
    """Run ``steps`` engine steps (None: until idle) under torch.profiler
    (device activity only). Device time is summed by kernel group
    (``groups``, then other GEMMs, then the rest); device ops are counted
    a step. The idle share is 1 - busy / window wall time; it is also
    given against the unprofiled run's step p50 of the same kind of
    step. If the profiler records no device time the breakdown reads "not
    measured"; if it does, every ``required`` group must have matched a
    device kernel (a renamed kernel would otherwise read 0 ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps0 = eng.stats["step_count"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        while eng.busy() and (steps is None
                              or eng.stats["step_count"] - steps0 < steps):
            eng.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_group = dict.fromkeys((*groups, "other_gemm", "other"), 0.0)
    kernels = {}
    ops = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        name = e.key
        low = name.lower()
        group = next((g for g, keys in groups.items()
                      if any(k in name for k in keys)), None)
        if group is None:
            group = "other_gemm" if any(
                w in low for w in ("gemm", "xmma", "nvjet", "cutlass")) \
                else "other"
        by_group[group] += ms
        kernels[name] = kernels.get(name, 0.0) + ms
        ops += e.count
    busy = sum(by_group.values())
    for g in required:
        check(not busy or by_group[g] > 0,
              f"[{tag}] no device kernel matched group {g!r} "
              f"({groups[g]}): kernels {sorted(kernels)}")
    n = eng.stats["step_count"] - steps0
    busy_step = busy / n
    out = {"steps": n, "window_ms": wall_ms, "device_busy_ms": busy,
           "device_busy_per_step_ms": busy_step,
           "device_ops_per_step": ops / n,
           "idle_share": (1 - busy / wall_ms) if busy else "not measured",
           "idle_share_vs_unprofiled_p50": (1 - busy_step / step_p50_ms)
           if busy else "not measured",
           "by_group_ms": by_group,
           "top_kernels_ms": sorted(kernels.items(), key=lambda kv: -kv[1])[:8]}
    if busy:
        share = ", ".join(f"{g} {ms:.1f} ms ({ms / busy:.0%})"
                          for g, ms in by_group.items())
        log(f"[{tag}] {n} steps in {wall_ms:.1f} ms wall, device busy "
            f"{busy:.1f} ms = {busy_step:.1f} ms a step, {ops / n:.0f} "
            f"device ops a step (idle share {out['idle_share']:.1%} of the "
            f"window, {out['idle_share_vs_unprofiled_p50']:.1%} of the "
            f"unprofiled step p50 {step_p50_ms:.1f} ms): {share}")
        for name, ms in out["top_kernels_ms"]:
            log(f"[{tag}]   {ms:9.2f} ms  {name[:90]}")
    else:
        log(f"[{tag}] the profiler recorded no device time: not measured")
    return out


# ------------------------------------------------------------------ phase 8

#: phase 8's unique suffixes after the shared 512-token system prompt (32
#: full pages); an eighth request repeats request 2's whole prompt
PREFIX_SUFFIXES = (37, 61, 90, 118, 143, 171, 199)
#: request 7 arrives once request 2 has emitted this many tokens: its
#: decode has then registered the block holding its prompt's last 10
#: tokens, which request 7's prompt ends inside (a partial-tail hit)
REPEAT_AFTER = 8
#: phase 8's runs: name -> serve() keywords (4 slots x 1024, 16-token
#: pages, 256-row mixed step). Concurrency needs ~61 pages; 56 is below
#: it, while one request's worst case (743 tokens, 47 pages) fits.
PREFIX_PHASE_RUNS = {
    "A: mixed, no prefix cache, eager": dict(),
    "B: mixed, prefix cache": dict(prefix_cache=True),
    "C: mixed, prefix cache, lazy, 56 pages": dict(
        prefix_cache=True, lazy=True, kv_pages=56),
    "D: split, prefix cache, lazy, 56 pages": dict(
        prefix_cache=True, lazy=True, kv_pages=56, mixed=False),
}


def _cuda_sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def prefix_prompts(seed: int, vocab: int):
    """Phase 8's 8 prompts (phase 20 serves them too): one 512-token
    system prompt and ``PREFIX_SUFFIXES``' suffixes, drawn from ``seed``;
    the last repeats the third."""
    rng = np.random.default_rng(seed + 8)
    system = rng.integers(0, vocab, size=(512,))
    prompts = [np.concatenate([system, rng.integers(
        0, vocab, size=(n,))]).astype(np.int32) for n in PREFIX_SUFFIXES]
    prompts.append(prompts[2].copy())
    return prompts


def phase_prefix(session, seed: int, max_new: int = 32):
    """PREFIX SHARING, LAZY GROWTH, COPY-ON-WRITE AND PREEMPTION at full
    width, on phase 5's session (its weights): 8 prompts opening with one
    512-token system prompt (``PREFIX_SUFFIXES``), ``max_new`` greedy
    tokens each, through each of ``PREFIX_PHASE_RUNS``. Requests 0-6 are
    submitted at once; request 7, a repeat of request 2's whole prompt
    with a deadline (so the scheduler admits it at the next free slot),
    arrives once request 2 has emitted ``REPEAT_AFTER`` tokens: under
    lazy it takes a partial-tail hit on a page request 2 still holds, and
    copies it on its first decode write. Counts are zeroed just
    before and read just after each run: every kernel of the run's path
    launched as ``_want_launches`` says. Runs B and C must give run A's
    streams token for token (a paged row's bits do not depend on the
    rows beside it); B takes >= 7 x 32 prefix blocks from the cache at a
    lower page peak than A; C preempts and copies on write at least once,
    finishes every request, runs one program shape a page bucket and
    leaves no page in use once the prefix cache is released. Run D (the
    split path, which prefills through flash attention) reports the share
    of its tokens equal to run A's."""
    from repro_torch import kernels
    from repro_torch.serve.paging import pages_for
    from repro_torch.serve.step import page_bucket
    cfg = session.cfg
    prompts = prefix_prompts(seed, cfg.vocab_size)
    buckets = len({page_bucket(pages_for(min(len(p) + max_new - 1, 1024),
                                         16), cap=64) for p in prompts})
    out, streams = {}, {}
    for name, kw in PREFIX_PHASE_RUNS.items():
        key = name[0]
        eng = session.serve(slots=4, max_len=1024, page_size=16,
                            chunk_tokens=256, **kw)
        live = [eng.submit(rid, p, max_new=max_new)
                for rid, p in enumerate(prompts[:7])]
        _cuda_sync()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        step_s = []
        t0 = time.perf_counter()
        while eng.busy():
            s0 = time.perf_counter()
            eng.step()
            step_s.append(time.perf_counter() - s0)
            if len(live) == 7 and len(live[2].out) >= REPEAT_AFTER:
                live.append(eng.submit(7, prompts[7], max_new=max_new,
                                       deadline_s=600.0))
        _cuda_sync()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        want = _want_launches(eng, cfg.num_layers) \
            if eng.device.type == "cuda" else dict.fromkeys(counts, 0)
        check(counts == want, f"[prefix {key}] launches {counts} != {want}")
        res = eng.results()
        for rid in range(len(prompts)):
            r = res[rid]
            check(r.done and len(r.out) == max_new
                  and all(0 <= t < cfg.vocab_size for t in r.out),
                  f"[prefix {key}] request {rid} done={r.done} with "
                  f"{len(r.out)} tokens")
        streams[key] = [list(res[rid].out) for rid in range(len(prompts))]
        st = eng.stats
        run = {k: st[k] for k in PREFIX_COUNTERS + (
            "peak_pages", "decode_traces", "prefills", "decode_steps",
            "mixed_steps", "prefill_chunk_tokens")}
        run["kv_pages"] = eng.kv_pages
        run["released_blocks"] = eng.release_prefix_cache()
        run["pages_in_use_after_release"] = eng.stats["pages_in_use"]
        check(run["pages_in_use_after_release"] == 0,
              f"[prefix {key}] {run['pages_in_use_after_release']} pages in "
              f"use after release_prefix_cache()")
        check(st["decode_traces"] <= buckets,
              f"[prefix {key}] {st['decode_traces']} program shapes > "
              f"{buckets} page bucket(s)")
        step_ms = np.asarray(step_s) * 1e3
        tokens = sum(len(x) for x in streams[key])
        run.update(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
                   steps=len(step_s),
                   step_p50_ms=float(np.percentile(step_ms, 50)),
                   peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                                if torch.cuda.is_available() else 0.0),
                   launches=counts, streams=streams[key])
        if key != "A":
            run["tokens_equal_to_A"] = sum(
                a == b for g, w in zip(streams[key], streams["A"])
                for a, b in zip(g, w)) / tokens
        out[name] = run
        log(f"[prefix {name}] {tokens} tokens in {wall:.2f}s = "
            f"{run['tokens_per_s']:.2f} tok/s, {len(step_s)} steps, step "
            f"p50 {run['step_p50_ms']:.1f} ms, peak {run['peak_mem_gb']:.2f}"
            f" GB, peak pages {st['peak_pages']}/{eng.kv_pages}; "
            + ", ".join(f"{k} {st[k]}" for k in PREFIX_COUNTERS)
            + f"; {st['decode_traces']} program shape(s); launches {counts}"
            + (f"; {run['tokens_equal_to_A']:.1%} of tokens equal to run A"
               if key != "A" else ""))
        del eng
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    a, b, c = (out[n] for n in list(PREFIX_PHASE_RUNS)[:3])
    for key in "BC":
        check(streams[key] == streams["A"],
              f"[prefix {key}] greedy streams differ from run A's "
              f"(share equal {out[[n for n in out if n[0] == key][0]]['tokens_equal_to_A']:.3f})")
    check(b["prefix_hit_blocks"] >= 7 * 32,
          f"[prefix B] {b['prefix_hit_blocks']} prefix hit blocks < 224")
    check(b["peak_pages"] < a["peak_pages"],
          f"[prefix B] peak pages {b['peak_pages']} not below run A's "
          f"{a['peak_pages']}")
    check(c["preemptions"] >= 1 and c["cow_copies"] >= 1,
          f"[prefix C] preemptions {c['preemptions']}, CoW copies "
          f"{c['cow_copies']}: each must be >= 1")
    return out


# ------------------------------------------------------------------ phase 9

#: phase 9's runs: name -> serve() keywords beside 4 slots x 1024, 16-token
#: pages and the 256-row mixed step ("spec" is filled in per run)
SPEC_PHASE_RUNS = {
    "A: spec off": dict(),
    "B: ngram drafter, k 4": dict(spec="ngram"),
    "C: as B, prefix cache, lazy, 56 pages": dict(
        spec="ngram", prefix_cache=True, lazy=True, kv_pages=56),
    "D: self-drafting model, k 4, 2 slots": dict(spec="model", slots=2),
}
#: run D serves the first requests only, with fewer new tokens (every draft
#: token costs a forward of phase 5's layers over up to 1024 positions)
SPEC_D_REQUESTS, SPEC_D_NEW = 2, 16


def _spec_prompts(rng, vocab: int):
    """Phase 9's traffic: 4 prompts of motifs of 3-6 tokens tiled to
    200-600 tokens (the reference's ``_repetitive_prompts`` at serving
    length: repeated boilerplate and retrieved text) and 4 random prompts
    of 24-700 tokens, interleaved."""
    rep = []
    for _ in range(4):
        motif = rng.integers(0, vocab, size=(int(rng.integers(3, 7)),))
        n = int(rng.integers(200, 601))
        rep.append(np.resize(motif, n).astype(np.int32))
    rnd = [rng.integers(0, vocab, size=(int(n),)).astype(np.int32)
           for n in rng.integers(24, 701, size=4)]
    return [p for pair in zip(rep, rnd) for p in pair]


def _per_slot_step(st) -> float:
    """Tokens per (decode step, slot): 1.0 without speculation."""
    return (st["decode_tokens"] - st["prefills"]) / max(
        st["decode_slot_steps"], 1)


def phase_spec(session, seed: int, max_new: int = 32):
    """SPECULATIVE DECODE at full width on phase 5's session (its
    weights): ``_spec_prompts``, ``max_new`` greedy tokens each, through
    each of ``SPEC_PHASE_RUNS``. Counts are zeroed just before and read
    just after each run and must equal the mixed step's (plus the draft
    model's forwards in run D). Runs B, C and D must give run A's bf16
    streams token for token, with A's program shapes in B; B accepts some
    drafts and emits more than one token per (decode step, slot); C
    leaves no page in use once its prefix cache is released; D (the
    verifier's own config and weights as the drafter) reports how often
    the split forward's argmax agrees with the mixed step's."""
    from repro_torch import kernels
    from repro_torch.serve.speculative import SpecConfig
    from repro_torch.tree import tree_map
    cfg = session.cfg
    prompts = _spec_prompts(np.random.default_rng(seed + 9), cfg.vocab_size)
    draft_params = tree_map(torch.Tensor.detach, session.params)
    out, streams = {}, {}
    for name, kw in SPEC_PHASE_RUNS.items():
        key, kw = name[0], dict(kw)
        drafter = kw.pop("spec", None)
        if drafter == "model":
            spec = SpecConfig(k=4, drafter="model", draft_cfg=cfg,
                              draft_params=draft_params)
        else:
            spec = None if drafter is None else SpecConfig(k=4)
        kw.setdefault("slots", 4)
        eng = session.serve(max_len=1024, page_size=16, chunk_tokens=256,
                            spec=spec, **kw)
        rollback = {"calls": 0, "pages": 0}
        if eng.lazy:
            real = eng._alloc.rollback

            def counted(owner, n_tokens, real=real):
                dropped = real(owner, n_tokens)
                rollback["calls"] += 1
                rollback["pages"] += len(dropped)
                return dropped
            eng._alloc.rollback = counted
        reqs = prompts[:SPEC_D_REQUESTS] if key == "D" else prompts
        new = SPEC_D_NEW if key == "D" else max_new
        for rid, p in enumerate(reqs):
            eng.submit(rid, p, max_new=new)
        _cuda_sync()
        kernels.reset_launches()
        step_s = []
        t0 = time.perf_counter()
        while eng.busy():
            s0 = time.perf_counter()
            eng.step()
            step_s.append(time.perf_counter() - s0)
        _cuda_sync()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        st = eng.stats
        # the model drafter's forwards (one a draft token: no lazy pool
        # truncates its drafts) run flash and the fused MLP once a layer
        forwards = st["spec_drafted"] if key == "D" else 0
        want = _want_launches(eng, cfg.num_layers)
        want["fused_mlp"] += cfg.num_layers * forwards
        want["flash_attention"] += cfg.num_layers * forwards
        check(counts == want, f"[spec {key}] launches {counts} != {want}")
        res = eng.results()
        for rid in range(len(reqs)):
            r = res[rid]
            check(r.done and len(r.out) == new
                  and all(0 <= t < cfg.vocab_size for t in r.out),
                  f"[spec {key}] request {rid} done={r.done} with "
                  f"{len(r.out)} tokens")
        streams[key] = [list(res[rid].out) for rid in range(len(reqs))]
        step_ms = np.asarray(step_s) * 1e3
        tokens = sum(len(x) for x in streams[key])
        # the host time of each step's drafting (the tracer's "draft" lap:
        # the drafters' proposals and the draft pages' reservation)
        draft_ms = [rec["phases"].get("draft", 0.0) * 1e3
                    for rec in eng.tracer.flight()["steps"]]
        run = {k: st[k] for k in (
            "spec_drafted", "spec_accepted", "decode_steps", "mixed_steps",
            "decode_slot_steps", "prefills", "decode_traces", "peak_pages",
            "preemptions", "cow_copies", "prefix_hit_blocks")}
        run.update(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
                   steps=len(step_s),
                   step_p50_ms=float(np.percentile(step_ms, 50)),
                   accept_rate=st["spec_accepted"] / max(st["spec_drafted"],
                                                         1),
                   tokens_per_step_slot=_per_slot_step(st), launches=counts,
                   draft_ms_p50=float(np.percentile(draft_ms, 50)),
                   draft_ms_max=float(max(draft_ms)),
                   rollback_calls=rollback["calls"],
                   rollback_pages=rollback["pages"])
        if eng.prefix_cache:
            run["released_blocks"] = eng.release_prefix_cache()
            run["pages_in_use_after_release"] = eng.stats["pages_in_use"]
            check(run["pages_in_use_after_release"] == 0,
                  f"[spec {key}] {run['pages_in_use_after_release']} pages "
                  f"in use after release_prefix_cache()")
        if key != "A":
            want_streams = [s[:new] for s in streams["A"][:len(reqs)]]
            check(streams[key] == want_streams,
                  f"[spec {key}] greedy streams differ from run A's")
        out[name] = run
        log(f"[spec {name}] {tokens} tokens in {wall:.2f}s = "
            f"{run['tokens_per_s']:.2f} tok/s, {len(step_s)} steps "
            f"({st['decode_steps']} with decode rows), step p50 "
            f"{run['step_p50_ms']:.1f} ms (drafting p50 "
            f"{run['draft_ms_p50']:.2f} ms, max {run['draft_ms_max']:.2f});"
            f" drafted {st['spec_drafted']}, "
            f"accepted {st['spec_accepted']} ({run['accept_rate']:.1%}), "
            f"{run['tokens_per_step_slot']:.3f} tokens per (decode step, "
            f"slot); peak pages {st['peak_pages']}/{eng.kv_pages}, "
            f"preemptions {st['preemptions']}, CoW {st['cow_copies']}, "
            f"rollbacks {rollback['calls']} ({rollback['pages']} pages "
            f"dropped); {st['decode_traces']} program shape(s); launches "
            f"{counts}" + ("" if key == "A" else
                           "; streams equal to run A's"))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    a, b = out[list(SPEC_PHASE_RUNS)[0]], out[list(SPEC_PHASE_RUNS)[1]]
    check(b["decode_traces"] == a["decode_traces"],
          f"[spec B] {b['decode_traces']} program shapes != run A's "
          f"{a['decode_traces']}")
    check(b["spec_accepted"] > 0 and b["tokens_per_step_slot"] > 1.0,
          f"[spec B] accepted {b['spec_accepted']}, "
          f"{b['tokens_per_step_slot']:.3f} tokens per (decode step, slot)")
    return out, streams["B"], prompts


# ----------------------------------------------------------------- phase 10

def _post_json(url: str, body: dict, timeout: float):
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def phase_online(session, prompts, streams_b, max_new: int = 32):
    """ONLINE SERVING at full width on phase 5's session with phase 9's
    run B settings: ``Session.serve_async(start=False)``, all of phase
    9's prompts submitted, then started (its streams must equal run B's);
    then ``Session.serve_http(port=0)``: the same prompts POSTed to
    /generate from one client thread each (one with chunked streaming)
    while the loop runs, then GET /metrics and /healthz. Every response
    must carry ``max_new`` tokens, ``serve_ttft_seconds_count`` must equal
    the request count and /metrics' ``spec_drafted`` the engine's.
    Launches are counted as in phase 9. Reports TTFT and TPOT p50/p90 and
    (not asserted: arrival order changes the batches but not the bits of
    a row) the share of tokens equal to run B's."""
    import threading
    import urllib.request
    from repro_torch import kernels
    from repro_torch.serve.speculative import SpecConfig
    cfg = session.cfg
    kw = dict(slots=4, max_len=1024, page_size=16, chunk_tokens=256,
              spec=SpecConfig(k=4))
    out = {}
    drv = session.serve_async(start=False, watchdog_timeout=120.0, **kw)
    live = [drv.submit(p, max_new=max_new, rid=i)
            for i, p in enumerate(prompts)]
    _cuda_sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    drv.start()
    got = [list(s.result(timeout=600.0).out) for s in live]
    wall = time.perf_counter() - t0
    drv.stop(drain=True, timeout=60.0)
    counts = kernels.launches()
    want = _want_launches(drv.engine, cfg.num_layers)
    check(counts == want, f"[online async] launches {counts} != {want}")
    check(got == streams_b, "[online async] deferred-start driver streams "
          "differ from phase 9's run B")
    lat = drv.metrics.latency_summary()
    out["async"] = {"tokens": sum(map(len, got)), "wall_s": wall,
                    "tokens_per_s": sum(map(len, got)) / wall,
                    "launches": counts, "latency": lat,
                    "spec_drafted": drv.engine.stats["spec_drafted"],
                    "spec_accepted": drv.engine.stats["spec_accepted"]}
    log(f"[online async, deferred start] {out['async']['tokens']} tokens in "
        f"{wall:.2f}s = {out['async']['tokens_per_s']:.2f} tok/s; streams "
        f"equal to phase 9 run B's; TTFT p50 {lat['ttft_p50_s']:.3f} s, "
        f"TPOT p50 {lat['tpot_p50_s'] * 1e3:.1f} ms; launches {counts}")
    del drv
    gc.collect()
    torch.cuda.empty_cache()

    server = session.serve_http(port=0, watchdog_timeout=120.0, **kw)
    bodies, errors = {}, []

    def client(i):
        try:
            body = {"prompt": [int(t) for t in prompts[i]],
                    "max_new": max_new, "timeout": 600.0,
                    "stream": i == 0}
            with _post_json(f"{server.url}/generate", body, 600.0) as r:
                if i == 0:
                    lines = [json.loads(ln) for ln in r if ln.strip()]
                    bodies[i] = {"tokens": [ln["token"] for ln in
                                            lines[:-1]],
                                 "closing": lines[-1]}
                else:
                    bodies[i] = json.loads(r.read())
        except Exception as exc:       # reported below, fails the phase
            errors.append(f"request {i}: {exc!r}")

    try:
        _cuda_sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900.0)
        wall = time.perf_counter() - t0
        check(not errors and not any(t.is_alive() for t in threads),
              f"[online http] clients failed or hung: {errors}")
        with urllib.request.urlopen(f"{server.url}/metrics",
                                    timeout=60) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(f"{server.url}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        eng = server.driver.engine
        counts = kernels.launches()
        st = server.driver.stats()
        lat = server.driver.metrics.latency_summary()
    finally:
        server.close(drain=False)
    want = _want_launches(eng, cfg.num_layers)
    check(counts == want, f"[online http] launches {counts} != {want}")
    toks = [bodies[i]["tokens"] for i in range(len(prompts))]
    check(all(len(t) == max_new for t in toks),
          f"[online http] token counts {[len(t) for t in toks]}")
    check(bodies[0]["closing"].get("done") is True
          and bodies[0]["closing"]["tokens"] == toks[0],
          "[online http] the streamed response's closing record")
    check(f"serve_ttft_seconds_count {len(prompts)}" in metrics,
          "[online http] serve_ttft_seconds_count != the request count")
    drafted = re.search(r"^serve_engine_spec_drafted (\S+)$", metrics, re.M)
    check(drafted is not None and float(drafted[1]) == st["spec_drafted"],
          f"[online http] /metrics spec_drafted "
          f"{drafted[1] if drafted else None} != {st['spec_drafted']}")
    check(health["status"] == "ok", f"[online http] /healthz {health}")
    equal = sum(a == b for g, w in zip(toks, streams_b)
                for a, b in zip(g, w)) / sum(map(len, toks))
    out["http"] = {"tokens": sum(map(len, toks)), "wall_s": wall,
                   "tokens_per_s": sum(map(len, toks)) / wall,
                   "launches": counts, "latency": lat,
                   "tokens_equal_to_B": equal,
                   "spec_drafted": st["spec_drafted"],
                   "spec_accepted": st["spec_accepted"],
                   "steps": st["step_count"]}
    log(f"[online http] {len(prompts)} clients, {out['http']['tokens']} "
        f"tokens in {wall:.2f}s = {out['http']['tokens_per_s']:.2f} tok/s, "
        f"{st['step_count']} steps; TTFT p50 {lat['ttft_p50_s']:.3f} s, p90 "
        f"{lat['ttft_p90_s']:.3f} s; TPOT p50 {lat['tpot_p50_s'] * 1e3:.1f} "
        f"ms, p90 {lat['tpot_p90_s'] * 1e3:.1f} ms; accepted "
        f"{st['spec_accepted']}/{st['spec_drafted']}; {equal:.1%} of tokens "
        f"equal to phase 9 run B's (reported); /metrics spec_drafted = the "
        f"engine's; launches {counts}")
    return out


# ------------------------------------------------------------------ phase 6

def phase_train(seed: int, steps: int = 6, layers: int = 4, *,
                arch: str = "qwen3-14b", strategy=None, data_cls=None,
                session=None):
    """The TRAIN PATH of ``arch`` at full width, depth cut to ``layers``
    (None: uncut); seq_len 4096 unless it does not fit the card, then 2048
    (said in the record). ``strategy``: the session's (default: the
    default Strategy, AdamW); ``data_cls``: the trainer's data class
    (``launch/train.py``'s ``FramesData`` or ``ImagesData``; default the
    token dataset), one row of ``seq_len`` tokens from ``seed``;
    ``session``: the session to train (default: a new one from ``seed``,
    as ``_train_run`` makes it), kept by the caller."""
    from repro_torch.configs import get_config
    cfg = get_config(arch) if session is None else session.cfg
    if layers and session is None:
        cfg = cfg.with_(num_layers=layers)
    for seq_len in (4096, 2048):
        try:
            data = None if data_cls is None else data_cls(
                cfg, global_batch=1, seq_len=seq_len, seed=seed)
            return _train_run(cfg, seed, steps, seq_len, data=data,
                              strategy=strategy, session=session)
        except torch.cuda.OutOfMemoryError as exc:
            if seq_len == 2048:
                raise
            log(f"[train] seq_len {seq_len} does not fit the card ({exc}); "
                f"cutting seq_len to 2048")
        # the failed run's tensors die with the exception's frames
        gc.collect()
        torch.cuda.empty_cache()


def _train_run(cfg, seed: int, steps: int, seq_len: int, *,
               global_batch: int = 1, data=None, strategy=None,
               session=None, profile: bool = True):
    """``steps`` steps of ``global_batch`` x ``seq_len`` tokens through
    ``Session.train`` (``data``: the trainer's data object, default the
    token dataset; ``strategy``: the session's, default the default
    Strategy; ``session``: a session to train, default a new one from
    ``seed``): exact launch counts, finite losses, the step p50,
    tokens/s, peak memory, the model-FLOPs share and (``profile``) the
    profile."""
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.train.trainer import TrainConfig
    from repro_torch.tree import flatten
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if session is None:
        session = Session(cfg, device="cuda", seed=seed, strategy=strategy)
    trainer = session.train(TrainConfig(steps=steps, lr=3e-4, log_every=1,
                                        seed=seed), data=data,
                            global_batch=global_batch, seq_len=seq_len)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in flatten(session.params).values())
    n_embed = session.params["tok_embed" if cfg.arch_type == "audio"
                             else "embed"].numel()
    s = trainer.strategy
    full = get_config(cfg.name).num_layers == cfg.num_layers
    log(f"[train] {cfg.name} "
        + ("uncut" if full else f"cut to {cfg.num_layers} layers")
        + f" ({cfg.num_layers} layers; width uncut: "
        f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads x "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, "
        + (f"{cfg.num_experts} experts top {cfg.experts_per_token}, "
           if cfg.is_moe else "")
        + (f"{cfg.encoder_layers} encoder layers over "
           f"{cfg.encoder_ctx} frames, " if cfg.arch_type == "audio" else "")
        + (f"a cross layer after every {cfg.cross_attn_every} self layers "
           f"over {cfg.num_image_tokens} image tokens, "
           if cfg.arch_type == "vlm" else "")
        + f"SSD heads {cfg.ssm_heads} x "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, vocab "
        f"{cfg.vocab_size}), {cfg.dtype}, {n_params / 1e9:.3f} B params; "
        f"strategy "
        f"{s.optimizer}, remat={s.remat}, attn_impl={s.attn_impl!r}; "
        f"params + {s.optimizer} state ready in "
        f"{time.perf_counter() - t0:.1f}s")
    kernels.reset_launches()
    step_s = []
    for _ in range(steps):
        s0 = time.perf_counter()
        trainer.run(1)                 # ends in float(loss): a sync
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s0)
    counts = kernels.launches()
    hist = trainer.history
    check(len(hist) == steps, f"{len(hist)} logged steps != {steps}")
    for h in hist:
        check(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              and math.isfinite(h["aux_loss"]),
              f"step {h['step']}: loss {h['loss']}, aux loss "
              f"{h['aux_loss']}, grad_norm {h['grad_norm']}")
    flops, n_applied, flash_step = train_flops(cfg, session.params, seq_len,
                                               global_batch)
    want = {"flash_attention": flash_step * steps,
            "fused_mlp": 0, "paged_attention": 0, "ssd_scan": 0}
    check(counts == want, f"train launches {counts} != {want} (flash: "
                          f"{flash_step} a step, every attention layer's "
                          f"forward and each decoder layer's remat "
                          f"recompute; the SSD scan trains through its "
                          f"plain version)")
    peak = torch.cuda.max_memory_allocated()
    check(peak < card_bytes, f"peak {peak} >= card {card_bytes}")
    tokens = global_batch * seq_len
    p50 = float(np.percentile(step_s, 50))
    model_flops = sum(flops.values())
    out = {"arch": cfg.name, "layers": cfg.num_layers, "depth_cut": not full,
           "optimizer": s.optimizer,
           "seq_len": seq_len,
           "seq_len_cut": seq_len < (WHISPER_TRAIN if cfg.arch_type
                                     == "audio" else 4096),
           "global_batch": global_batch,
           "steps": steps, "params": n_params,
           "params_without_embed": n_params - n_embed,
           "params_applied": n_applied, "model_flops_by_term": flops,
           "step_s": step_s, "step_p50_s": p50,
           "first_step_s": step_s[0], "tokens_per_s": tokens / p50,
           "peak_mem_gb": peak / 1e9, "card_mem_gb": card_bytes / 1e9,
           "model_flops_per_step": model_flops,
           "model_flops_share_of_989T": model_flops / p50 / 989e12,
           "losses": [h["loss"] for h in hist],
           "aux_losses": [h["aux_loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "launches": counts}
    log(f"[train] {cfg.name}: {steps} steps of {global_batch} x {seq_len} "
        f"tokens: step "
        f"p50 "
        f"{p50 * 1e3:.1f} ms (first {step_s[0] * 1e3:.1f} ms), "
        f"{out['tokens_per_s']:.1f} tokens/s, peak memory "
        f"{out['peak_mem_gb']:.2f} GB of {out['card_mem_gb']:.2f} GB, model "
        f"FLOPs {model_flops / 1e12:.2f} T a step = "
        f"{out['model_flops_share_of_989T']:.2%} of 989 TFLOP/s; losses "
        f"{[round(x, 4) for x in out['losses']]}"
        + (f", aux losses {[round(x, 4) for x in out['aux_losses']]}"
           if cfg.is_moe else "") + f"; launches {counts}")
    if profile:
        out["profile"] = _train_profile(trainer, p50,
                                        need_flash=flash_step > 0)
    del trainer, session
    return out


def ssd_flops(cfg, seq_len: int) -> float:
    """The SSD scan's products a Mamba layer's forward needs at batch 1
    (the phase-3 bound's count: C.B^T over the causal pairs of each
    chunk, the intra-chunk y, the chunk states and the inter-chunk y)."""
    q = min(cfg.ssm_chunk, seq_len)
    pairs = q * (q + 1) // 2
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return 2.0 * (seq_len // q) * (pairs * n + h * (pairs * p + 2 * q * n * p))


def encdec_train_flops(cfg, flat, seq_len: int, batch: int):
    """An enc-dec training step's model FLOPs, by term (``train_flops``):
    6 x batch x (the encoder's parameters and the cross K/V projections
    (``dec_layers/xattn/wk``, ``wv``) x the frames, the decoder's other
    parameters and ``lm_head`` x the tokens; the embedding gather not
    counted); the attention forward and backward (3x): the encoder's
    non-causal self-attention 4 F^2 Hq D a layer, the decoder's causal 4 S
    (S + 1) / 2 Hq D and its cross-attention 4 S F Hq D a layer. Returns
    (by term, N_applied a token, flash launches a step: each encoder
    layer, each decoder layer and its remat recompute)."""
    f, s = cfg.encoder_ctx, seq_len
    enc = sum(t.numel() for k, t in flat.items()
              if k.startswith("enc_layers/") or k == "enc_norm")
    xkv = sum(t.numel() for k, t in flat.items()
              if k in ("dec_layers/xattn/wk", "dec_layers/xattn/wv"))
    dec = sum(t.numel() for k, t in flat.items()
              if k.startswith("dec_layers/") or k in ("final_norm",
                                                     "lm_head")) - xkv
    hd = 4.0 * cfg.num_heads * cfg.head_dim
    attn = 3 * batch * (hd * f * f * cfg.encoder_layers
                        + hd * s * (s + 1) / 2 * cfg.num_layers
                        + hd * s * f * cfg.num_layers)
    return ({"6_n_frames": 6.0 * batch * (enc + xkv) * f,
             "6_n_tokens": 6.0 * batch * dec * s, "attention": attn},
            dec + (enc + xkv) * f / s,
            cfg.encoder_layers + 2 * cfg.num_layers)


def vlm_train_flops(cfg, flat, seq_len: int, batch: int):
    """A VLM training step's model FLOPs, by term (``train_flops``): 6 x
    batch x (the applied self layers' parameters, the cross layers' ``wq``,
    ``wo`` and MLP, and ``lm_head``) x the tokens; 6 x batch x the cross
    layers' ``wk`` and ``wv`` x the image tokens; the attention forward
    and backward (3x): the causal self-attention 4 S (S + 1) / 2 Hq D a
    self layer and the cross-attention 4 S F Hq D a cross layer. The
    embedding gather, the norms and gates, and the unused trailing layer
    (rest 0) are not counted. Returns (by term, N_applied a token, flash
    launches a step: each self layer's forward, and the remat recompute
    of each grouped one)."""
    g, rest = cfg.vlm_groups
    f, s = cfg.num_image_tokens, seq_len

    def size(prefixes):
        return sum(t.numel() for k, t in flat.items()
                   if k.startswith(prefixes))

    xkv = size(("cross/xattn/wk", "cross/xattn/wv"))
    tok = size(("self_groups/attn/", "self_groups/mlp/", "cross/xattn/wq",
                "cross/xattn/wo", "cross/mlp/", "lm_head")) \
        + (size(("trailing/attn/", "trailing/mlp/")) if rest else 0)
    hd = 4.0 * cfg.num_heads * cfg.head_dim
    self_layers = g * cfg.cross_attn_every + rest
    attn = 3 * batch * (hd * s * (s + 1) / 2 * self_layers + hd * s * f * g)
    return ({"6_n_tokens": 6.0 * batch * tok * s,
             "6_n_images": 6.0 * batch * xkv * f, "attention": attn},
            tok + xkv * f / s, 2 * g * cfg.cross_attn_every + rest)


def train_flops(cfg, params, seq_len: int, batch: int = 1):
    """A training step's model FLOPs at ``batch`` rows, by term: 6
    N_applied tokens, N_applied the parameters without the embedding
    gather, the hybrid's shared block counted once an application (G
    times), an MoE layer's experts at k / E of their parameters (each
    token runs k of the E experts) and its router in full; the causal
    attention's forward (4 S (S + 1) / 2 Hq D a layer) and backward (2x
    forward) in each attention layer (dense and MoE: every layer; hybrid:
    G); the SSD scan's products (``ssd_flops``) forward and backward (3x)
    in every Mamba layer; the enc-dec family by ``encdec_train_flops``,
    the VLM by ``vlm_train_flops``.
    Returns (by term, N_applied, flash launches a step: each attention
    layer's forward and its remat recompute)."""
    from repro_torch.tree import flatten
    flat = flatten(params)
    if cfg.arch_type == "audio":
        return encdec_train_flops(cfg, flat, seq_len, batch)
    if cfg.arch_type == "vlm":
        return vlm_train_flops(cfg, flat, seq_len, batch)
    n = sum(t.numel() for k, t in flat.items() if k != "embed")
    if cfg.is_moe:
        experts = sum(t.numel() for k, t in flat.items()
                      if k.startswith("layers/moe/w_"))
        n -= experts * (1 - cfg.experts_per_token / cfg.num_experts)
    attn_layers, mamba_layers = cfg.num_layers, 0
    if cfg.arch_type == "ssm":
        attn_layers, mamba_layers = 0, cfg.num_layers
    elif cfg.arch_type == "hybrid":
        attn_layers = cfg.num_layers // cfg.hybrid_attn_every
        mamba_layers = cfg.num_layers
        n += (attn_layers - 1) * sum(t.numel() for k, t in flat.items()
                                     if k.startswith("shared/"))
        if cfg.num_layers % cfg.hybrid_attn_every == 0:   # unused trailing
            n -= sum(t.numel() for k, t in flat.items()
                     if k.startswith("trailing/"))
    attn = 3 * 4.0 * cfg.num_heads * cfg.head_dim * seq_len \
        * (seq_len + 1) / 2 * attn_layers
    return ({"6_n_tokens": 6.0 * batch * n * seq_len,
             "attention": batch * attn,
             "ssd": 3 * batch * ssd_flops(cfg, seq_len) * mamba_layers},
            n, 2 * attn_layers)


def _kernels_by_range(prof, ranges):
    """The device kernels of a profile taken with host and device activity,
    each as (name, ms, range): ``range`` is the one of ``ranges`` (names of
    ``record_function`` ranges that do not overlap on the host) whose host
    interval holds the start of the op that launched the kernel, else
    None. The raw kineto events link each device event to that op
    (``linked_correlation_id`` = the op's ``correlation_id``; runtime calls
    carry a link of their own and are not ops). A range is matched by
    time, not by thread: the backward's ops run on autograd's own thread
    while its range stays open on the caller's."""
    from torch.autograd import DeviceType
    raw = prof.profiler.kineto_results.events()
    cpu, dev = DeviceType.CPU, DeviceType.CUDA
    spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in raw
                   if e.device_type() == cpu and e.name() in ranges)
    starts = [sp[0] for sp in spans]
    op_start = {e.correlation_id(): e.start_ns() for e in raw
                if e.device_type() == cpu and not e.linked_correlation_id()}
    out = []
    for e in raw:
        if e.device_type() != dev or e.is_user_annotation() \
                or e.name() in ranges:
            continue                # a range's span on the device timeline
        start = op_start.get(e.linked_correlation_id())
        i = bisect.bisect_right(starts, start) - 1 if start is not None \
            else -1
        out.append((e.name(), (e.end_ns() - e.start_ns()) / 1e6,
                    spans[i][2] if i >= 0 and start <= spans[i][1]
                    else None))
    return out


def _train_profile(trainer, step_p50_s: float, need_flash: bool = True):
    """Where a train step's time goes: one more step under torch.profiler
    (host and device activity, after a warm-up profiler session as phase 5
    does). Device time is summed by kernel group, and by the step's parts
    (the ``record_function`` ranges ``train/step.py::PARTS``): each device
    event goes to the part whose host interval holds the start of the op
    that launched it, since the backward's ops run on autograd's own
    thread while its range stays open on the caller's; what no part holds
    is ``outside_parts``. "Not measured" if the profiler records no device
    time; if it does, the flash group must have matched a device kernel."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.step import PARTS
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        trainer.run(1)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # fp32 GEMMs are the attention backward's einsums (the model's own
    # matmuls are bf16); softmax kernels are its recompute
    groups = {"flash_attention": 0.0, "gemm_bf16": 0.0, "gemm_fp32": 0.0,
              "softmax": 0.0, "other": 0.0}
    parts = dict.fromkeys(PARTS + ("outside_parts",), 0.0)
    kernels = {}
    for name, ms, part in _kernels_by_range(prof, PARTS):
        parts[part or "outside_parts"] += ms
        low = name.lower()
        if "flash_fwd" in name:     # flash_fwd_wgmma_kernel, flash_fwd_kernel
            group = "flash_attention"
        elif "f32f32" in low or "sgemm" in low:
            group = "gemm_fp32"
        elif any(w in low for w in ("gemm", "xmma", "nvjet", "cutlass")):
            group = "gemm_bf16"
        elif "softmax" in low:
            group = "softmax"
        else:
            group = "other"
        groups[group] += ms
        kernels[name] = kernels.get(name, 0.0) + ms
    busy = sum(groups.values())
    check(not busy or not need_flash or groups["flash_attention"] > 0,
          f"[train profile] no device kernel matched flash_fwd: kernels "
          f"{sorted(kernels)}")
    out = {"parts_device_ms": parts, "window_ms": wall_ms,
           "device_busy_ms": busy,
           "idle_share_vs_unprofiled_p50": (1 - busy / (step_p50_s * 1e3))
           if busy else "not measured",
           "by_group_ms": groups,
           "top_kernels_ms": sorted(kernels.items(),
                                    key=lambda kv: -kv[1])[:12]}
    if busy:
        share = ", ".join(f"{g} {ms:.1f} ms ({ms / busy:.0%})"
                          for g, ms in groups.items())
        log(f"[train profile] one step: {wall_ms:.1f} ms wall under the "
            f"profiler, device busy {busy:.1f} ms (idle share "
            f"{out['idle_share_vs_unprofiled_p50']:.1%} of the unprofiled "
            f"step p50 {step_p50_s * 1e3:.1f} ms): {share}")
        log("[train profile] device time by part: " + ", ".join(
            f"{n} {ms:.1f} ms" for n, ms in parts.items()))
        for name, ms in out["top_kernels_ms"]:
            log(f"[train profile]   {ms:9.2f} ms  {name[:90]}")
    else:
        log("[train profile] the profiler recorded no device time: not "
            "measured")
    return out


# ------------------------------------------------------------------ phase 7

#: phases 7, 11 and 27: the prompt lengths (each <= 128 or a multiple of
#: it: the reference's chunk precondition), drawn in this order from
#: ``default_rng(seed)``
SSM_PROMPTS = (1024, 640, 384, 256, 128, 77)
#: the depth at which phases 7, 11, 12 and 27 run the SSM family and the
#: hybrid at full width (the script's time limit; uncut until phases
#: 32-33): Mamba2-780M 24 of its 48 layers, Zamba2-1.2B 20 of its 38 (3
#: groups of 6 Mamba layers and the shared block, and 2 trailing layers,
#: as its 6 groups and 2)
FAMILY_LAYERS = {"mamba2-780m": 24, "zamba2-1.2b": 20}


def family_config(arch: str):
    """``arch``'s config at full width, depth cut to ``FAMILY_LAYERS``."""
    from repro_torch.configs import get_config
    return get_config(arch).with_(num_layers=FAMILY_LAYERS[arch])


def ssm_requests(rng, vocab: int):
    """Phase 7's / 11's prompts from ``rng``, one a length of
    ``SSM_PROMPTS``."""
    return [rng.integers(0, vocab, size=(n,)) for n in SSM_PROMPTS]


def _serve_family(arch: str, seed: int, tag: str, want_fn):
    """Serve ``arch`` at full width through ``Session(family_config(arch),
    device="cuda").serve(slots=4, max_len=2048)`` (random weights from
    ``seed``): six requests of 1024, 640, 384, 256, 128 and 77 prompt
    tokens (each <= 128 or a multiple of it: the reference's chunk
    precondition), 32 new tokens each. Counts are zeroed just before and
    read just after, and must equal ``want_fn(cfg, prefills, decode
    steps)``; every request finishes with 32 in-vocab tokens,
    ``prefill_traces`` equals the 6 distinct lengths and ``decode_traces``
    1. Returns (record, engine, session, rng)."""
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.tree import flatten
    cfg = family_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = Session(cfg, device="cuda", seed=seed)
    eng = session.serve(slots=4, max_len=2048)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flatten(session.params).values())
    heads = (f"shared block every {cfg.hybrid_attn_every} layers: "
             f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, "
             f"d_ff {cfg.d_ff}; " if cfg.arch_type == "hybrid" else "")
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {heads}{cfg.ssm_heads} SSD heads x "
        f"{cfg.ssm_head_dim}, "
        f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, {n_params / 1e6:.1f} M params; "
        f"weights + decode state ready in {time.perf_counter() - t0:.1f}s "
        f"(decode state {eng.kv_bytes() / 1e6:.1f} MB); paged={eng.paged}, "
        f"mixed={eng.mixed}")
    rng = np.random.default_rng(seed)
    lens = SSM_PROMPTS
    max_new = 32
    for rid, prompt in enumerate(ssm_requests(rng, cfg.vocab_size)):
        eng.submit(rid, prompt, max_new=max_new)
    kernels.reset_launches()
    step_s, prefill_step = [], []
    t0 = time.perf_counter()
    while eng.busy():
        s0 = time.perf_counter()
        pf0 = eng.stats["prefills"]
        eng.step()
        step_s.append(time.perf_counter() - s0)
        prefill_step.append(eng.stats["prefills"] > pf0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    res = eng.results()
    st = eng.stats
    for rid in range(len(lens)):
        r = res[rid]
        check(r.done and len(r.out) == max_new,
              f"request {rid} finished={r.done} with {len(r.out)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out),
              f"request {rid} tokens out of range")
    want = want_fn(cfg, st["prefills"], st["decode_steps"])
    check(st["prefills"] == len(lens) and counts == want,
          f"{tag} launches {counts} != {want}")
    check(st["prefill_traces"] == len(set(lens)),
          f"prefill_traces {st['prefill_traces']} != {len(set(lens))} "
          f"distinct prompt lengths")
    check(st["decode_traces"] == 1,
          f"decode_traces {st['decode_traces']} != 1")
    check(bool(torch.isfinite(eng.last_logits).all()), "finite logits")
    tokens = sum(len(res[r].out) for r in res)
    step_ms = np.asarray(step_s) * 1e3
    with_pf = np.asarray(prefill_step)
    out = {"layers": cfg.num_layers, "params": n_params,
           "prompt_lens": list(lens), "max_new": max_new, "tokens": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "steps": len(step_s), "prefills": st["prefills"],
           "decode_steps": st["decode_steps"],
           "step_p50_ms": float(np.percentile(step_ms, 50)),
           "step_max_ms": float(step_ms.max()),
           "prefill_steps": int(with_pf.sum()),
           "prefill_step_p50_ms": float(np.percentile(step_ms[with_pf], 50)),
           "decode_only_step_p50_ms": float(
               np.percentile(step_ms[~with_pf], 50)),
           "prefill_tokens": int(sum(lens)),
           "decode_state_bytes": eng.kv_bytes(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decode_traces": st["decode_traces"],
           "prefill_traces": st["prefill_traces"], "launches": counts,
           "streams": [list(res[rid].out) for rid in range(len(lens))]}
    log(f"[{tag}] {len(lens)} requests (prompts {list(lens)}), {tokens} "
        f"tokens in {wall:.2f}s = {out['tokens_per_s']:.2f} tok/s; "
        f"{len(step_s)} steps, step p50 {out['step_p50_ms']:.1f} ms (with a "
        f"prefill {out['prefill_step_p50_ms']:.1f} ms over "
        f"{out['prefill_steps']} steps, decode only "
        f"{out['decode_only_step_p50_ms']:.1f} ms), max "
        f"{out['step_max_ms']:.1f} ms; peak memory {out['peak_mem_gb']:.2f} "
        f"GB, decode state {eng.kv_bytes() / 1e6:.1f} MB; launches {counts}; "
        f"prefill_traces {st['prefill_traces']}, decode_traces "
        f"{st['decode_traces']}")
    return out, eng, session, rng


def _ssm_want(cfg, prefills: int, decode_steps: int) -> dict:
    """Launches of a Mamba2 run on the card: the SSD scan in every layer
    of every prefill, the other kernels never."""
    return {"paged_attention": 0, "fused_mlp": 0, "flash_attention": 0,
            "ssd_scan": cfg.num_layers * prefills}


def phase_ssm(seed: int):
    """The SSM SERVING PATH: ``_serve_family`` on Mamba2-780M (24 layers,
    bf16): the split path, one exact-length prefill a request through the
    SSD kernel and one batched recurrent decode a step; the SSD kernel
    must have run layers x prefills times, the other kernels never. Then
    one more pair of requests (512 and 77 tokens, 12 new each): the
    admission step (two prefills and a decode) and the decode-only steps
    after it are profiled apart, each against the unprofiled p50 of its
    kind."""
    out, eng, _, rng = _serve_family("mamba2-780m", seed, "ssm", _ssm_want)
    groups = {"ssd_scan": SSD_LAUNCHES}
    out["profile"] = phase_profile(
        eng, rng, out["prefill_step_p50_ms"], prompts=(512, 77),
        max_new=12, groups=groups, tag="ssm profile: admission step",
        steps=1, required=("ssd_scan",))
    out["profile_decode"] = _profile_steps(
        eng, out["decode_only_step_p50_ms"], groups,
        "ssm profile: decode-only steps")
    return out


# ----------------------------------------------------------------- phase 11

#: phase 11's kernel groups: the SSD scan's four launches, flash attention
#: (the shared block's prefill) and the fused MLP's launches
HYBRID_GROUPS = {"ssd_scan": SSD_LAUNCHES, "flash_attention": ("flash_fwd",),
                 "fused_mlp": SERVE_GROUPS["fused_mlp"]}


def _hybrid_want(cfg, prefills: int, decode_steps: int) -> dict:
    """Launches of a hybrid run on the card: the SSD scan in every Mamba
    layer of every prefill, flash in every application of the shared
    block in every prefill, the fused MLP in every application in every
    program (prefill or decode), paged attention never."""
    g = cfg.num_layers // cfg.hybrid_attn_every
    return {"paged_attention": 0, "fused_mlp": g * (prefills + decode_steps),
            "flash_attention": g * prefills,
            "ssd_scan": cfg.num_layers * prefills}


def phase_hybrid(seed: int):
    """HYBRID SERVING: ``_serve_family`` on Zamba2-1.2B (20 layers: 3
    groups of 6 Mamba layers and the shared block, 2 trailing; bf16)
    through the split path, with ``_hybrid_want``'s launch counts; then
    one more pair under torch.profiler (admission step, decode-only
    steps), then ``Session.generate`` of a (4, 512) prompt for 16 steps
    (one prefill and 15 decodes)."""
    from repro_torch import kernels
    out, eng, session, rng = _serve_family("zamba2-1.2b", seed, "hybrid",
                                           _hybrid_want)
    cfg = session.cfg
    check(set(out["prompt_lens"]) | {512, 77} <= set(HYBRID_PROMPTS),
          f"phase 3 checks no kernel at some of phase 11's prompt lengths "
          f"{sorted(set(out['prompt_lens']) - set(HYBRID_PROMPTS))}")
    out["groups"] = cfg.num_layers // cfg.hybrid_attn_every
    out["profile"] = phase_profile(
        eng, rng, out["prefill_step_p50_ms"], prompts=(512, 77),
        max_new=12, groups=HYBRID_GROUPS,
        tag="hybrid profile: admission step", steps=1,
        required=tuple(HYBRID_GROUPS))
    out["profile_decode"] = _profile_steps(
        eng, out["decode_only_step_p50_ms"], HYBRID_GROUPS,
        "hybrid profile: decode-only steps", required=("fused_mlp",))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    prompt = rng.integers(0, cfg.vocab_size, size=(4, 512))
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = session.generate(prompt, steps=16)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = kernels.launches()
    want = _hybrid_want(cfg, 1, 15)
    check(tuple(toks.shape) == (4, 16) and gen_counts == want,
          f"generate: shape {tuple(toks.shape)}, launches {gen_counts} != "
          f"{want}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "generate tokens out of range")
    out["generate"] = {"batch": 4, "prompt": 512, "steps": 16,
                       "wall_s": gen_s, "tokens_per_s": 64 / gen_s,
                       "launches": gen_counts}
    log(f"[hybrid generate] (4, 512) x 16 in {gen_s:.2f}s "
        f"({64 / gen_s:.1f} tokens/s); launches {gen_counts}")
    out["launches"] = {k: out["launches"][k] + gen_counts[k]
                       for k in gen_counts}
    del session
    return out


# ----------------------------------------------------------------- phase 12

def phase_train_families(seed: int, steps: int = 3):
    """SSM AND HYBRID TRAINING at full width, depth cut to
    ``FAMILY_LAYERS``: Mamba2-780M (24 of 48 layers) and Zamba2-1.2B (20
    of 38), AdamW, remat, 1 x 4096 tokens
    (2048 only if 4096 does not fit, said in the record), ``steps`` steps
    each, with phase 6's checks, FLOPs share and profile."""
    out = {}
    for arch in ("mamba2-780m", "zamba2-1.2b"):
        out[arch] = phase_train(seed, steps, layers=FAMILY_LAYERS[arch],
                                arch=arch)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------- phases 13-14

#: the MoE serving profile's device-time groups: paged attention and flash
#: by kernel name; the MoE FFN's parts by the ``record_function`` range
#: (``models/moe.py::PARTS``) holding the op that launched each kernel
MOE_KERNEL_GROUPS = {"paged_attention": ("paged_attention_kernel",
                                         *PAGED_LAUNCHES),
                     "flash_attention": ("flash_fwd",)}
MOE_PART_GROUPS = {"moe_route": "routing_dispatch",
                   "moe_experts": "expert_products",
                   "moe_combine": "combine"}


def _profile_groups(eng, step_p50_ms: float, tag: str, steps=None,
                 required=("paged_attention",), *,
                 kernel_groups=MOE_KERNEL_GROUPS,
                 part_groups=MOE_PART_GROUPS):
    """Run ``steps`` engine steps (None: until idle) under torch.profiler
    (host and device activity) and sum the device time by group: the
    attention kernels by name (``kernel_groups``); by default routing and
    dispatch (router matmul, softmax, sort, one-hot count, scatter), the
    expert products (three batched matmuls and the SwiGLU) and the
    combine by the MoE range holding the op that launched the kernel
    (``part_groups``: range -> group); the rest as ``other_gemm``
    (projections, head) or ``other``. The idle share is 1 - device busy a
    step / the unprofiled step p50 of the same kind of step (the
    profiler's host cost stays out of it). Fails if a ``required`` group
    or a part got no device time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    steps0 = eng.stats["step_count"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        while eng.busy() and (steps is None
                              or eng.stats["step_count"] - steps0 < steps):
            eng.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    groups = dict.fromkeys((*kernel_groups, *part_groups.values(),
                            "other_gemm", "other"), 0.0)
    kernels, ops = {}, 0
    for name, ms, part in _kernels_by_range(prof, part_groups):
        ops += 1
        group = next((g for g, keys in kernel_groups.items()
                      if any(k in name for k in keys)), None) \
            or part_groups.get(part)
        if group is None:
            low = name.lower()
            group = "other_gemm" if any(
                w in low for w in ("gemm", "xmma", "nvjet", "cutlass")) \
                else "other"
        groups[group] += ms
        kernels[name] = kernels.get(name, 0.0) + ms
    busy = sum(groups.values())
    for g in (*required, *part_groups.values()):
        check(not busy or groups[g] > 0,
              f"[{tag}] no device time in group {g!r}: kernels "
              f"{sorted(kernels)[:20]}")
    n = eng.stats["step_count"] - steps0
    busy_step = busy / max(n, 1)
    out = {"steps": n, "window_ms": wall_ms, "device_busy_ms": busy,
           "device_busy_per_step_ms": busy_step,
           "device_ops_per_step": ops / max(n, 1),
           "idle_share_vs_unprofiled_p50": (1 - busy_step / step_p50_ms)
           if busy else "not measured",
           "by_group_ms": groups,
           "top_kernels_ms": sorted(kernels.items(),
                                    key=lambda kv: -kv[1])[:8]}
    if busy:
        share = ", ".join(f"{g} {ms:.2f} ms ({ms / busy:.0%})"
                          for g, ms in groups.items())
        log(f"[{tag}] {n} steps in {wall_ms:.1f} ms wall under the "
            f"profiler, device busy {busy:.1f} ms = {busy_step:.2f} ms a "
            f"step, {ops / max(n, 1):.0f} device ops a step (idle share "
            f"{out['idle_share_vs_unprofiled_p50']:.1%} of the unprofiled "
            f"step p50 {step_p50_ms:.1f} ms): {share}")
        for name, ms in out["top_kernels_ms"]:
            log(f"[{tag}]   {ms:9.2f} ms  {name[:90]}")
    else:
        log(f"[{tag}] the profiler recorded no device time: not measured")
    return out


def _drive(eng, prompts, max_new: int, tag: str, *, mixed: bool,
           frames=None, images=None):
    """Submit ``prompts`` (``max_new`` new tokens each; with ``frames`` or
    ``images``, each request's own), zero the launch counts, step the
    engine until
    idle and read them: each request must finish with ``max_new``
    in-vocab tokens. A step with prefill work is one that moved
    prefill-chunk tokens (``mixed``) or ran a prefill. Returns the run's
    record (its streams and launches in it)."""
    from repro_torch import kernels
    cfg = eng.cfg
    for rid, p in enumerate(prompts):
        eng.submit(rid, p, max_new=max_new,
                   frames=None if frames is None else frames[rid],
                   images=None if images is None else images[rid])
    key = "prefill_chunk_tokens" if mixed else "prefills"
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step_s, prefill_step = [], []
    t0 = time.perf_counter()
    while eng.busy():
        s0 = time.perf_counter()
        before = eng.stats[key]
        eng.step()
        step_s.append(time.perf_counter() - s0)
        prefill_step.append(eng.stats[key] > before)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    res = eng.results()
    for rid in range(len(prompts)):
        r = res[rid]
        check(r.done and len(r.out) == max_new,
              f"[{tag}] request {rid} finished={r.done} with {len(r.out)} "
              f"tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out),
              f"[{tag}] request {rid} tokens out of range")
    check(bool(torch.isfinite(eng.last_logits).all()), f"[{tag}] finite "
                                                        f"logits")
    st = eng.stats
    tokens = sum(len(res[r].out) for r in res)
    step_ms = np.asarray(step_s) * 1e3
    with_pf = np.asarray(prefill_step)
    return {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "steps": len(step_s), "program_runs": st["mixed_steps"],
            "prefills": st["prefills"], "decode_steps": st["decode_steps"],
            "step_p50_ms": float(np.percentile(step_ms, 50)),
            "step_max_ms": float(step_ms.max()),
            "prefill_steps": int(with_pf.sum()),
            "prefill_step_p50_ms": float(np.percentile(step_ms[with_pf], 50)),
            "decode_only_step_p50_ms": float(
                np.percentile(step_ms[~with_pf], 50)),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "kv_gb": eng.kv_bytes() / 1e9, "kv_bytes": eng.kv_bytes(),
            "per_device_kv_bytes": eng.per_device_kv_bytes(),
            "peak_pages": st["peak_pages"],
            "decode_traces": st["decode_traces"],
            "prefill_traces": st["prefill_traces"],
            "encode_traces": st["encode_traces"], "launches": counts,
            "streams": [list(res[rid].out) for rid in range(len(prompts))]}


def _run_text(tag: str, run: dict) -> str:
    return (f"[{tag}] {run['tokens']} tokens in {run['wall_s']:.2f}s = "
            f"{run['tokens_per_s']:.2f} tok/s; {run['steps']} steps, step "
            f"p50 {run['step_p50_ms']:.1f} ms (with prefill work "
            f"{run['prefill_step_p50_ms']:.1f} ms over {run['prefill_steps']}"
            f" steps, decode only {run['decode_only_step_p50_ms']:.1f} ms), "
            f"max {run['step_max_ms']:.1f} ms; peak memory "
            f"{run['peak_mem_gb']:.2f} GB (KV {run['kv_gb']:.2f} GB), peak "
            f"pages {run['peak_pages']}; launches {run['launches']}; "
            f"decode_traces {run['decode_traces']}, prefill_traces "
            f"{run['prefill_traces']}")


def phase_moe_serve(seed: int, max_new: int = 16):
    """MoE SERVING at full width, uncut (phases 13 and 13b):
    ``Session(get_config("olmoe-1b-7b"), device="cuda").serve(slots=4,
    max_len=1024, page_size=16, chunk_tokens=256)`` (16 layers, bf16,
    random weights from ``seed``) on phase 5's six prompts, 16 new tokens
    each, through the mixed step: paged attention exactly 16 x program
    runs, the other kernels never, ``decode_traces`` within the (chunk,
    page bucket) pairs; then ``serve(mixed=False)`` (the split path on
    the pool) on the same requests: flash 16 x prefills, paged attention
    16 x decode steps, the fused MLP never, one prefill shape a distinct
    prompt length (no bucket) and each a length phase 3 checked, and the
    share of tokens equal to phase 13's streams (reported: in bf16
    capacity couples rows differently on the two paths). Each path then
    serves one more pair under the profiler (``_profile_groups``)."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.serve.paging import pages_for
    from repro_torch.serve.step import page_bucket
    from repro_torch.tree import flatten
    cfg = get_config("olmoe-1b-7b")
    layers = cfg.num_layers
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    session = Session(cfg, device="cuda", seed=seed)
    n_params = sum(t.numel() for t in flatten(session.params).values())
    log(f"[moe] {cfg.name}: {layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, "
        f"{cfg.num_experts} experts top {cfg.experts_per_token} of d_ff "
        f"{cfg.d_ff}, capacity factor {cfg.moe_capacity_factor}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, {n_params / 1e9:.3f} B params "
        f"({n_params * 2 / 1e9:.2f} GB); weights ready in "
        f"{time.perf_counter() - t0:.1f}s")
    lens, prompts = serving_prompts(seed, cfg.vocab_size)
    out = {"params": n_params, "prompt_lens": [int(n) for n in lens],
           "max_new": max_new}
    rng = np.random.default_rng(seed + 13)

    # phase 13: the mixed step
    eng = session.serve(slots=4, max_len=1024, page_size=16,
                        chunk_tokens=256)
    run = _drive(eng, prompts, max_new, "moe mixed", mixed=True)
    buckets = {page_bucket(max(pages_for(min(int(n) + max_new - 1, 1024), 16)
                               for n in lens[:i + 1]), cap=64)
               for i in range(len(lens))}
    want = {"paged_attention": layers * run["program_runs"],
            "fused_mlp": 0, "flash_attention": 0, "ssd_scan": 0}
    check(run["launches"] == want,
          f"[moe mixed] launches {run['launches']} != {want} (paged "
          f"attention {layers} layers x {run['program_runs']} program runs)")
    check(run["decode_traces"] <= len(buckets),
          f"[moe mixed] {run['decode_traces']} program shapes > "
          f"{len(buckets)} (chunk, page bucket) pairs")
    log(_run_text("moe mixed", run))
    run["profile"] = _profile_moe_pair(eng, rng, run["step_p50_ms"],
                                       "moe mixed profile: the pair")
    out["mixed"] = run
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # phase 13b: the split path on the pool
    eng = session.serve(slots=4, max_len=1024, page_size=16, mixed=False)
    split = _drive(eng, prompts, max_new, "moe split", mixed=False)
    want = {"paged_attention": layers * split["decode_steps"],
            "fused_mlp": 0, "flash_attention": layers * split["prefills"],
            "ssd_scan": 0}
    check(split["launches"] == want,
          f"[moe split] launches {split['launches']} != {want} (flash "
          f"{layers} x prefills, paged attention {layers} x decode steps)")
    check(split["prefill_traces"] == len({int(n) for n in lens}),
          f"[moe split] prefill_traces {split['prefill_traces']} != "
          f"{len(set(lens))} distinct prompt lengths (no bucket)")
    check(split["decode_traces"] == 1,
          f"[moe split] decode_traces {split['decode_traces']}")
    checked = {shape[1] for shape in moe_flash_shapes(seed)}
    check(set(eng._prefill_lens) <= checked,
          f"[moe split] prefill lengths {sorted(eng._prefill_lens)} not all "
          f"held by phase 3 ({sorted(checked)})")
    agree = sum(a == b for g, w in zip(split["streams"], run["streams"])
                for a, b in zip(g, w)) / (max_new * len(prompts))
    split["agree_with_mixed"] = agree
    log(_run_text("moe split", split)
        + f"; {agree:.1%} of tokens equal to phase 13's mixed-step streams "
        f"(information)")
    split["profile"] = _profile_moe_pair(
        eng, rng, split["prefill_step_p50_ms"],
        "moe split profile: admission step", steps=1,
        required=("paged_attention", "flash_attention"))
    split["profile_decode"] = _profile_groups(
        eng, split["decode_only_step_p50_ms"],
        "moe split profile: decode-only steps")
    check(set(eng._prefill_lens) <= checked,
          f"[moe split] profiled prefill lengths {sorted(eng._prefill_lens)}"
          f" not all held by phase 3 ({sorted(checked)})")
    out["split"] = split
    del eng, session
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _profile_moe_pair(eng, rng, step_p50_ms: float, tag: str, steps=None,
                      required=("paged_attention",)):
    """Submit one more pair (``MOE_PROFILE_PROMPTS`` tokens, 4 new each)
    and profile the engine's next ``steps`` steps (``_profile_groups``)."""
    for rid, n in enumerate(MOE_PROFILE_PROMPTS):
        eng.submit(100 + rid, rng.integers(0, eng.cfg.vocab_size, size=n),
                   max_new=4)
    return _profile_groups(eng, step_p50_ms, tag, steps, required)


AUDIO_KERNEL_GROUPS = {"flash_attention": ("flash_fwd",),
                       "paged_attention": ("paged_attention_kernel",
                                           *PAGED_LAUNCHES)}


def _audio_part_groups():
    from repro_torch.models.encdec import CROSS_RANGE
    return {CROSS_RANGE: "cross_attention"}


def phase_whisper_serve(seed: int, max_new: int = WHISPER_NEW):
    """AUDIO SERVING at full width, uncut (phases 15 and 15b):
    ``Session(get_config("whisper-tiny"), device="cuda").serve(slots=8,
    max_len=448, page_size=16, chunk_tokens=256)`` (4 encoder and 4
    decoder layers, bf16, random weights from ``seed``) on 8 requests of
    4-224 prompt tokens, each with its own (1500, 384) frames, 64 new
    tokens each, through the mixed step: paged attention exactly 4 x
    program runs, flash exactly 4 x admissions (the encoder program), the
    fused MLP and the SSD scan never, one encode shape, ``decode_traces``
    within the (chunk, page bucket) pairs; the encode program's device
    time a request; one more pair under the profiler (encoder flash, paged
    attention, cross-attention, other GEMMs, elementwise, idle share).
    Then ``serve(mixed=False)`` (the split path on the pool) on the same
    requests: flash 8 x prefills, paged attention 4 x decode steps, the
    fused MLP never, one prefill shape a distinct prompt length (no
    bucket), each a length phase 3 held; the share of tokens equal to
    phase 15's streams (reported: bf16 rounds differently on the two
    paths)."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.serve.paging import pages_for
    from repro_torch.serve.step import page_bucket
    from repro_torch.tree import flatten
    cfg = get_config("whisper-tiny")
    layers, enc_layers = cfg.num_layers, cfg.encoder_layers
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    session = Session(cfg, device="cuda", seed=seed)
    n_params = sum(t.numel() for t in flatten(session.params).values())
    lens, prompts, frames = whisper_requests(seed, cfg.vocab_size,
                                             cfg.d_model, cfg.encoder_ctx)
    log(f"[audio] {cfg.name}: {enc_layers} encoder + {layers} decoder "
        f"layers, d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.encoder_ctx} frames, {cfg.dtype}, "
        f"{n_params / 1e6:.2f} M params ({n_params * 2 / 1e6:.1f} MB); "
        f"weights and requests ready in {time.perf_counter() - t0:.1f}s; "
        f"prompt lengths {[int(n) for n in lens]}")
    out = {"params": n_params, "prompt_lens": [int(n) for n in lens],
           "max_new": max_new}
    kw = dict(slots=WHISPER_SLOTS, max_len=WHISPER_MAX_LEN, page_size=16)

    # phase 15: the mixed step
    eng = session.serve(chunk_tokens=256, **kw)
    run = _drive(eng, prompts, max_new, "audio mixed", mixed=True,
                 frames=frames)
    pps = pages_for(WHISPER_MAX_LEN, 16)
    buckets = {page_bucket(max(pages_for(min(int(n) + max_new - 1,
                                             WHISPER_MAX_LEN), 16)
                               for n in lens[:i + 1]), cap=pps)
               for i in range(len(lens))}
    want = {"paged_attention": layers * run["program_runs"],
            "fused_mlp": 0, "ssd_scan": 0,
            "flash_attention": enc_layers * run["prefills"]}
    check(run["launches"] == want,
          f"[audio mixed] launches {run['launches']} != {want} (paged "
          f"attention {layers} x {run['program_runs']} program runs, flash "
          f"{enc_layers} x {run['prefills']} admissions)")
    check(run["encode_traces"] == 1,
          f"[audio mixed] encode_traces {run['encode_traces']} != 1")
    check(run["decode_traces"] <= len(buckets),
          f"[audio mixed] {run['decode_traces']} program shapes > "
          f"{len(buckets)} (chunk, page bucket) pairs")
    f0 = torch.from_numpy(frames[0][None]).cuda()
    run["encode_ms"] = time_ms(lambda: eng._encode_fn(f0, 0), iters=5,
                               warmup=1)
    log(_run_text("audio mixed", run)
        + f"; encode_traces {run['encode_traces']}; the encode program "
        f"{run['encode_ms']:.3f} ms a request (CUDA events)")
    rng = np.random.default_rng(seed + 15)
    for rid, n in enumerate(WHISPER_PROFILE_PROMPTS):
        eng.submit(100 + rid, rng.integers(0, cfg.vocab_size, size=n),
                   max_new=4, frames=rng.standard_normal(
                       (cfg.encoder_ctx, cfg.d_model), dtype=np.float32))
    run["profile"] = _profile_groups(
        eng, run["step_p50_ms"], "audio mixed profile: the pair",
        required=("paged_attention", "flash_attention"),
        kernel_groups=AUDIO_KERNEL_GROUPS, part_groups=_audio_part_groups())
    out["mixed"] = run
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # phase 15b: the split path on the pool
    eng = session.serve(mixed=False, **kw)
    split = _drive(eng, prompts, max_new, "audio split", mixed=False,
                   frames=frames)
    want = {"paged_attention": layers * split["decode_steps"],
            "fused_mlp": 0, "ssd_scan": 0,
            "flash_attention": (enc_layers + layers) * split["prefills"]}
    check(split["launches"] == want,
          f"[audio split] launches {split['launches']} != {want} (flash "
          f"{enc_layers + layers} x prefills, paged attention {layers} x "
          f"decode steps)")
    check(split["prefill_traces"] == len({int(n) for n in lens}),
          f"[audio split] prefill_traces {split['prefill_traces']} != "
          f"{len(set(lens))} distinct prompt lengths (no bucket)")
    check(split["decode_traces"] == 1,
          f"[audio split] decode_traces {split['decode_traces']}")
    checked = {shape[1] for shape in whisper_flash_shapes(seed)
               if shape[6]}
    check(set(eng._prefill_lens) <= checked,
          f"[audio split] prefill lengths {sorted(eng._prefill_lens)} not "
          f"all held by phase 3 ({sorted(checked)})")
    agree = sum(a == b for g, w in zip(split["streams"], run["streams"])
                for a, b in zip(g, w)) / (max_new * len(prompts))
    split["agree_with_mixed"] = agree
    log(_run_text("audio split", split)
        + f"; {agree:.1%} of tokens equal to phase 15's mixed-step streams "
        f"(information)")
    out["split"] = split
    del eng, session
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_whisper_train(seed: int, steps: int = 6):
    """AUDIO TRAINING, uncut (phase 16): whisper-tiny, AdamW, remat, 6
    steps on a ``data=`` object (``launch/train.py::FramesData``) yielding
    8 x 448 tokens and one (8, 1500, 384) frames block from ``seed``:
    flash 6 x (4 encoder + 4 decoder + 4 decoder recompute), the other
    kernels never; loss and grad norm finite; step p50, tokens/s, peak
    memory, the profile by part and the model-FLOPs share of 989 TFLOP/s
    (``encdec_train_flops``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import FramesData
    cfg = get_config("whisper-tiny")
    data = FramesData(cfg, global_batch=8, seq_len=WHISPER_TRAIN, seed=seed)
    return _train_run(cfg, seed, steps, WHISPER_TRAIN, global_batch=8,
                      data=data)


# ------------------------------------------------------------ phases 17-18

#: Llama-3.2-Vision-90B (phases 17 and 18, and their parts of phases 3
#: and 4): self-attention heads (Hq, Hkv, D) = 64/8 x 128 (GQA rep 8), the
#: MLP's (d, f) = (8192, 28672), and the depth cuts (the 100 layers hold
#: ~177 GB of bf16 weights): phase 17 serves 4 of the 20 groups (16 self
#: and 4 cross layers, ~40.1 GB), phase 18 trains one (4 self and 1
#: cross layer, ~14.5 GB); each tree also holds the one trailing layer
#: the reference keeps and never applies at rest 0
VLM_HEADS = (64, 8, 128)
VLM_MLP = (8192, 28672)
VLM_SERVE_LAYERS, VLM_TRAIN_LAYERS, VLM_NEW = 20, 5, 16
VLM_TRAIN_LENS = (2048, 4096)


def vlm_prompt_lens(seed: int):
    """Phase 17's distinct prompt lengths: phase 5's six (an exact length
    each: a VLM prefill is not bucketed), ascending."""
    return sorted({int(n) for n in serving_prompts(seed, 2)[0]})


def vlm_images(seed: int, n: int, cfg):
    """``n`` requests' own (num_image_tokens, d_model) float32 patch
    embeddings from ``seed``, drawn in one block (the stubbed ViT tower
    and projector's output)."""
    rng = np.random.default_rng(seed + cfg.num_image_tokens)
    return list(rng.standard_normal((n, cfg.num_image_tokens, cfg.d_model),
                                    dtype=np.float32))


def vlm_flash_shapes(seed: int):
    """Flash attention's shapes on phases 17 and 18, (B, S, T, Hq, Hkv, D):
    each prompt length of phase 17 and phase 18's training rows (4096,
    and 2048 should 4096 not fit)."""
    hq, hkv, d = VLM_HEADS
    return tuple((1, n, n, hq, hkv, d)
                 for n in vlm_prompt_lens(seed) + list(VLM_TRAIN_LENS))


def phase_vlm_kernels(seed: int):
    """Flash attention and the fused MLP in bf16 at Llama-3.2-Vision-90B's
    shapes, every one phases 17 and 18 launch: flash causal at
    ``vlm_flash_shapes`` (rep 8, never run before this phase), the fused
    MLP at d 8192, f 28672 (K 8192 = 128 stages of 64; the widest before
    was d 5120 x f 17408) for T = 4 (the decode step) and each prompt
    length of phase 17, its weights at phase 17's init scales; each per
    value at its phase-3 limit, shown to reject its defective plain
    variant (dropped keys, a dropped 64-wide f tile), timed beside SDPA /
    the three cuBLAS matmuls with its bound; the MLP on 16 draws of x at
    T = 4 and at the shortest and the longest prompt. Inputs come from a
    generator of their own. Returns {kernel name: records} and the
    MLP's seed sweep; the 1.4 GB weight set is freed.

    The MLP's weights are at Llama-3.2-Vision-90B's own init scales (100
    layers: ``w_down`` 0.02 / sqrt(200)), which phase 17's depth-cut
    weights keep (``_uncut_init_scales``). At the 20-layer cut's own
    scale (0.02 / sqrt(40)) one flip of a bf16 h of 16-32 (ulp 0.125)
    moves an output by up to ~1.5e-3, past atol 1e-3, and the plain
    version itself then misses the exactly rounded h by more than the
    limit on some draws of x: that sweep (4 seeds at the two longest
    prompts) is printed beside, information, not a check."""
    from repro_torch.configs import get_config
    full_layers = get_config("llama-3.2-vision-90b").num_layers
    gen = torch.Generator(device="cuda").manual_seed(seed + 8192)
    out = {"flash_attention": [_flash_shape(gen, shape, 1e-5, 8e-3,
                                            timed=True)
                               for shape in vlm_flash_shapes(seed)]}
    d, f = VLM_MLP
    atol, rtol = 1e-3, 8e-3
    bf = torch.bfloat16
    wg = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wu = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wd = (torch.randn((f, d), generator=gen, device="cuda")
          * (0.02 / math.sqrt(2 * full_layers))).to(bf)
    lens = vlm_prompt_lens(seed)
    out["fused_mlp"] = [_mlp_rows(gen, rows, wg, wu, wd, atol, rtol,
                                  timed=True) for rows in [4] + lens]
    sweep = mlp_seed_sweep(wg, wu, wd, atol, rtol,
                           row_counts=(4, lens[0], lens[-1]))
    for rows, w in sweep.items():
        check(not w["seeds_a_over"], f"fused MLP bf16 at the VLM's "
              f"T={rows}: worst error {w['a']:.3f}x the limit on seeds "
              f"{w['seeds_a_over']} of {MLP_SWEEP_SEEDS}")
    out["fused_mlp_seed_sweep"] = sweep
    wd.mul_(math.sqrt(full_layers / VLM_SERVE_LAYERS))
    log(f"[mlp bf16 d={d} f={f}] information: w_down at the "
        f"{VLM_SERVE_LAYERS}-layer cut's own init scale, 0.02 / "
        f"sqrt({2 * VLM_SERVE_LAYERS}) — not checked")
    out["fused_mlp_cut_scale_sweep"] = mlp_seed_sweep(
        wg, wu, wd, atol, rtol, row_counts=tuple(lens[-2:]), seeds=4)
    del wg, wu, wd
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: phase 4's VLM configs: llama-vision-smoke (rest 0: one unused trailing
#: layer) and a rest > 0 variant (one group and one trailing self layer)
VLM_PARITY = {"rest 0": {}, "rest 1": dict(num_layers=4)}


def _vlm_want(cfg, prefills: int, decode_steps: int) -> dict:
    """Launches of a VLM run on the card (the split path on dense rows):
    flash once a self layer a prefill, the fused MLP once a layer (self
    or cross) a program (prefill or decode), the others never."""
    g, _ = cfg.vlm_groups
    return {"paged_attention": 0, "ssd_scan": 0,
            "fused_mlp": cfg.num_layers * (prefills + decode_steps),
            "flash_attention": (cfg.num_layers - g) * prefills}


def _open_gates(params):
    """Both gates of every cross layer to 1.0 (0 at init: the images
    would not move the logits, and a broken cross-attention would
    pass)."""
    with torch.no_grad():
        for gate in ("gate_attn", "gate_mlp"):
            params["cross"][gate].fill_(1.0)
    return params


def phase_parity_vlm():
    """``VLM_PARITY``'s configs in fp32 (TF32 off), gates open, through the
    split-path engine on dense rows on the card and on the CPU, each
    request with its own images: the first prefill's logits within 1e-4
    (a first request with max_new 1), every greedy stream identical, and
    on the card each kernel launched as ``_vlm_want`` says; then one train
    step each (remat on, 2 microbatches slicing tokens and images; flash
    on the card once a self layer a microbatch, and again for each grouped
    one's recompute): loss and gradients within 1e-4. Returns the
    errors."""
    from repro_torch import kernels
    from repro_torch.configs import get_smoke
    from repro_torch.core.strategy import Strategy
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for name, kw in VLM_PARITY.items():
        cfg = get_smoke("llama-3.2-vision-90b").with_(dtype="float32", **kw)
        g, rest = cfg.vlm_groups
        cpu = _open_gates(init_params(cfg, device="cpu", seed=11))
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
                   for n in (5, 23, 9, 40, 6)]
        images = list(rng.standard_normal(
            (len(prompts), cfg.num_image_tokens, cfg.d_model),
            dtype=np.float32))
        res, first = {}, {}
        for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
            eng = ServeEngine(cfg, params, slots=2, max_len=64)
            check(not eng.paged and not eng.mixed,
                  f"[parity vlm {name}] layout paged={eng.paged}, "
                  f"mixed={eng.mixed}")
            kernels.reset_launches()
            eng.submit(0, prompts[0], max_new=1, images=images[0])
            eng.step()
            first[dev] = eng.last_logits.detach().float().cpu()
            for i in range(1, len(prompts)):
                eng.submit(i, prompts[i], max_new=6, images=images[i])
            out = eng.run()
            res[dev] = {i: list(out[i].out) for i in out}
            want = _vlm_want(cfg, eng.stats["prefills"],
                             eng.stats["decode_steps"]) if dev == "cuda" \
                else dict.fromkeys(kernels.launches(), 0)
            check(kernels.launches() == want,
                  f"[parity vlm {name}] launches on {dev} "
                  f"{kernels.launches()} != {want}")
        err = (first["cpu"] - first["cuda"]).abs().max().item()
        check(err <= 1e-4, f"[parity vlm {name}] f32 first-prefill logits "
                           f"card vs CPU: {err} > 1e-4")
        check(res["cpu"] == res["cuda"],
              f"[parity vlm {name}] greedy streams differ: cpu "
              f"{res['cpu']} cuda {res['cuda']}")
        log(f"[parity vlm f32, TF32 off] llama-vision-smoke {name} (G {g}, "
            f"rest {rest}, gates open): first-prefill logits max abs err "
            f"card vs CPU {err:.3e} (<= 1e-4); greedy streams identical over "
            f"{len(prompts)} requests")
        strat = Strategy(remat=True, microbatches=2, dtype="float32")
        brng = np.random.default_rng(12)
        batch = {"tokens": torch.from_numpy(brng.integers(
            0, cfg.vocab_size, size=(4, 48)).astype(np.int32)),
            "image_embeds": torch.from_numpy(brng.standard_normal(
                (4, cfg.num_image_tokens, cfg.d_model), dtype=np.float32))}
        train = {}
        for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
            leaves = flatten(params)
            for t in leaves.values():
                t.requires_grad_(True)
            kernels.reset_launches()
            loss_fn = step.make_loss_fn(cfg, strat)
            losses, grads = [], None
            for i in (0, 2):      # the train step's two microbatches
                total, mets = loss_fn(params, {k: v[i:i + 2].to(dev)
                                               for k, v in batch.items()})
                gr = torch.autograd.grad(total, list(leaves.values()),
                                         materialize_grads=True)
                grads = gr if grads is None \
                    else [a + b for a, b in zip(grads, gr)]
                losses.append(float(mets["loss"].detach()))
            flash = kernels.launches()["flash_attention"]
            want = 2 * (2 * g * cfg.cross_attn_every + rest)
            check(flash == (want if dev == "cuda" else 0),
                  f"[parity vlm {name} train] flash launches on {dev}: "
                  f"{flash}")
            train[dev] = (losses, {k: (gr / 2).cpu()
                                   for k, gr in zip(leaves, grads)})
        loss_err = max(abs(a - b)
                       for a, b in zip(train["cpu"][0], train["cuda"][0]))
        grad_err = max((train["cuda"][1][k] - gr).abs().max().item()
                       for k, gr in train["cpu"][1].items())
        check(loss_err <= 1e-4 and grad_err <= 1e-4,
              f"llama-vision-smoke {name} f32 train step card vs CPU: loss "
              f"err {loss_err}, grads max abs err {grad_err} (limit 1e-4)")
        log(f"[parity vlm f32 train step, TF32 off] llama-vision-smoke "
            f"{name}, remat, 2 microbatches, losses "
            f"{[round(x, 6) for x in train['cpu'][0]]}: card vs CPU loss "
            f"err {loss_err:.3e}, grads max abs err {grad_err:.3e} (<= "
            f"1e-4)")
        errs[name] = {"first_prefill_err": err, "loss_err": loss_err,
                      "grad_err": grad_err}
    return errs


VLM_KERNEL_GROUPS = {"flash_attention": ("flash_fwd",),
                     "fused_mlp": SERVE_GROUPS["fused_mlp"]}


def _vlm_part_groups():
    from repro_torch.models.vlm import CROSS_RANGE
    return {CROSS_RANGE: "cross_attention"}


def _uncut_init_scales(params, cfg, full_layers: int):
    """Scale every ``wo`` and ``w_down`` of a depth-cut tree (drawn at
    0.02 / sqrt(2 cfg.num_layers)) to the uncut model's 0.02 / sqrt(2
    full_layers), in place: the cut serves layers distributed as the
    full model's are, the scale phase 3 holds the fused MLP at."""
    from repro_torch.tree import flatten
    ratio = math.sqrt(cfg.num_layers / full_layers)
    with torch.no_grad():
        for key, t in flatten(params).items():
            if key.endswith(("attn/wo", "mlp/w_down")):
                t.mul_(ratio)
    return params


def phase_vlm_serve(seed: int, max_new: int = VLM_NEW):
    """VLM SERVING at full width, depth cut (phase 17):
    ``Session(get_config("llama-3.2-vision-90b").with_(num_layers=20),
    device="cuda").serve(slots=4, max_len=1024)`` — the split path on dense
    rows, the only layout the reference serves the family on — with bf16
    random weights from ``seed`` (``wo`` and ``w_down`` at the uncut
    model's init scale, ``_uncut_init_scales``) and both gates of every
    cross layer at 1.0, on phase 5's six prompts, each with its own
    (1601, 8192) float32 images, 16 new tokens each (a multimodal chat or
    captioning user: one image and a text prompt a request). Counts are
    zeroed just before and read just after: flash 16 x prefills, the
    fused MLP 20 x (prefills + decode steps), the other kernels never; ``prefill_traces`` the number
    of distinct prompt lengths (no bucket, each one phase 3 held),
    ``decode_traces`` 1; every request finishes with 16 in-vocab tokens;
    the decode state is the self K/V rows of 17 layers (16 and the unused
    trailing one) and the image K/V blocks of 4. Prints tokens/s, the
    decode-only step p50 beside the floor of reading the weights a decode
    step needs at 3.35 TB/s, each prefill's time, peak memory; then one
    more request under the profiler: its admission step (the prefill and
    a decode) and one decode-only step, by group (flash, fused MLP, the
    cross-attention range, other GEMMs, the rest) with the idle share."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.tree import flatten
    cfg = get_config("llama-3.2-vision-90b").with_(
        num_layers=VLM_SERVE_LAYERS)
    g, rest = cfg.vlm_groups
    hq, hkv, hd = VLM_HEADS
    check((cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == VLM_HEADS
          and (cfg.d_model, cfg.d_ff) == VLM_MLP,
          f"{cfg.name}'s widths differ from phase 3's")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    session = Session(cfg, device="cuda", seed=seed)
    _uncut_init_scales(_open_gates(session.params), cfg,
                       get_config("llama-3.2-vision-90b").num_layers)
    flat = flatten(session.params)
    n_params = sum(t.numel() for t in flat.values())
    lens, prompts = serving_prompts(seed, cfg.vocab_size)
    images = vlm_images(seed, len(prompts), cfg)
    eng = session.serve(slots=4, max_len=1024)
    torch.cuda.synchronize()
    check(not eng.paged and not eng.mixed and not eng._bucketed,
          f"[vlm] layout paged={eng.paged}, mixed={eng.mixed}")
    row = 4 * 2 * hkv * hd * 2            # slots x (k, v) x Hkv x D x bf16
    self_kv = row * 1024 * (g * cfg.cross_attn_every + max(rest, 1))
    image_kv = row * cfg.num_image_tokens * g
    kv_want = self_kv + image_kv
    check(eng.kv_bytes() == kv_want,
          f"[vlm] decode state {eng.kv_bytes()} B != {kv_want} B (kv_g + "
          f"kv_t + xkv)")
    # the weights one decode step must read: every applied layer (the
    # cross layers' wk and wv only at prefill), the norms, lm_head
    read = sum(t.numel() * t.element_size() for k, t in flat.items()
               if k != "embed" and not k.startswith(
                   ("trailing/", "cross/xattn/wk", "cross/xattn/wv")))
    floor_ms = read / HBM_BYTES_PER_S * 1e3
    log(f"[vlm] {cfg.name} cut to {g} of 20 groups ({cfg.num_layers} "
        f"layers: {g * cfg.cross_attn_every} self + {g} cross, and the "
        f"unused trailing layer; width uncut: d_model {cfg.d_model}, "
        f"{hq}/{hkv} heads x {hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.num_image_tokens} image tokens), {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B params ({n_params * 2 / 1e9:.2f} GB), gates "
        f"open; weights, images and decode state ready in "
        f"{time.perf_counter() - t0:.1f}s (decode state "
        f"{eng.kv_bytes() / 1e6:.1f} MB: self K/V {self_kv / 1e6:.1f} MB, "
        f"image K/V {image_kv / 1e6:.1f} MB); "
        f"prompt lengths {[int(n) for n in lens]}")
    pf_ms = []

    def timed_prefill(*args, **kw):   # the prefill program, synchronised
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        tok = type(eng)._prefill_fn(eng, *args, **kw)
        torch.cuda.synchronize()
        pf_ms.append((int(args[0].shape[1]),
                      (time.perf_counter() - s0) * 1e3))
        return tok

    eng._prefill_fn = timed_prefill
    run = _drive(eng, prompts, max_new, "vlm", mixed=False, images=images)
    del eng._prefill_fn
    want = _vlm_want(cfg, run["prefills"], run["decode_steps"])
    check(run["prefills"] == len(prompts) and run["launches"] == want,
          f"[vlm] launches {run['launches']} != {want} (flash "
          f"{cfg.num_layers - g} self layers x prefills, the fused MLP "
          f"{cfg.num_layers} layers x programs)")
    check(run["prefill_traces"] == len(set(lens)),
          f"[vlm] prefill_traces {run['prefill_traces']} != "
          f"{len(set(lens))} distinct prompt lengths (no bucket)")
    check(run["decode_traces"] == 1,
          f"[vlm] decode_traces {run['decode_traces']}")
    held = {shape[1] for shape in vlm_flash_shapes(seed)}
    check(set(eng._prefill_lens) <= held,
          f"[vlm] prefill lengths {sorted(eng._prefill_lens)} not all held "
          f"by phase 3 ({sorted(held)})")
    run.update(params=n_params, prompt_lens=[int(n) for n in lens],
               max_new=max_new, decode_state_bytes=eng.kv_bytes(),
               decode_weight_bytes=read, decode_floor_ms=floor_ms,
               prefill_ms=pf_ms,
               prefill_p50_ms=float(np.percentile([m for _, m in pf_ms],
                                                  50)))
    log(_run_text("vlm", run)
        + f"; decode-only step p50 {run['decode_only_step_p50_ms']:.2f} ms "
        f"beside the floor {floor_ms:.2f} ms ({read / 1e9:.2f} GB of weights "
        f"at 3.35 TB/s); prefill per request (length, ms) "
        f"{[(n, round(m, 2)) for n, m in pf_ms]}")
    rng = np.random.default_rng(seed + 17)
    n = int(max(lens))
    eng.submit(100, rng.integers(0, cfg.vocab_size, size=n), max_new=4,
               images=vlm_images(seed + 1, 1, cfg)[0])
    kw = dict(kernel_groups=VLM_KERNEL_GROUPS,
              part_groups=_vlm_part_groups())
    run["profile"] = _profile_groups(
        eng, run["prefill_step_p50_ms"],
        f"vlm profile: admission step ({n}-token prefill + a decode)",
        steps=1, required=("flash_attention", "fused_mlp"), **kw)
    run["profile_decode"] = _profile_groups(
        eng, run["decode_only_step_p50_ms"],
        "vlm profile: a decode-only step", steps=1, required=("fused_mlp",),
        **kw)
    del eng, session, flat
    gc.collect()
    torch.cuda.empty_cache()
    return run


def phase_vlm_train(seed: int, steps: int = 6):
    """VLM TRAINING at full width, depth cut to one group (phase 18):
    Llama-3.2-Vision-90B at ``num_layers=5`` (4 self and 1 cross layer, and
    the unused trailing one: ~7.24 B params) with remat and Adafactor (the
    reference's memory-lean optimizer: AdamW's fp32 master, m and v would
    take >= 16 B a parameter, ~116 GB), ``steps`` steps on
    ``launch/train.py::ImagesData`` (1 x 4096 tokens, 2048 if 4096 does
    not fit, and one 1 x 1601 x 8192 image block from ``seed``), gates at
    their init of 0, as the reference trains: flash 8 a step (4 forward, 4
    recompute), the other kernels never; loss and grad norm finite; step
    p50, tokens/s, peak memory, the profile by part and the model-FLOPs
    share of 989 TFLOP/s (``vlm_train_flops``)."""
    from repro_torch.core.strategy import Strategy
    from repro_torch.launch.train import ImagesData
    out = phase_train(seed, steps, layers=VLM_TRAIN_LAYERS,
                      arch="llama-3.2-vision-90b",
                      strategy=Strategy(optimizer="adafactor"),
                      data_cls=ImagesData)
    check(out["seq_len"] in VLM_TRAIN_LENS,
          f"[vlm train] seq_len {out['seq_len']} not held by phase 3")
    return out


# ------------------------------------------ tensor-parallel serving (19)

#: Qwen3-14B's per-rank shapes at tp 2 (phase 19, on one card), and at tp
#: 4 and 8, which a box of 4 or 8 cards would launch: (Hq, Hkv) a rank,
#: d_model, d_ff a rank
TP_SHAPES = {2: ((20, 4), 5120, 8704), 4: ((10, 2), 5120, 4352),
             8: ((5, 1), 5120, 2176)}
#: phase 19's degree and the seconds its two rank processes may take; the
#: depth at which phases 19 and 26 serve Qwen3-14B (5 of its 40 layers:
#: the script's time limit; 20 from phases 30-31, 10 from phases 32-33)
TP_DEGREE, TP_TIMEOUT_S = 2, 480.0
TP_SERVE_LAYERS = 5


def phase_tp_kernels(seed: int):
    """The three serving kernels at the rank shapes of tensor-parallel
    Qwen3-14B (``TP_SHAPES``), bf16, each per value against its plain
    version at the limits phase 3 uses. At tp 2 (phase 19's): paged
    attention (``_paged_cases``) at the T = 256 mix and the split path's
    4-row decode table, both timed beside SDPA on the gathered KV with
    their bound; the fused MLP at d 5120, f 8704 for T 256 and each of
    phase 5b's row counts (``MLP_SPLIT_ROWS``), timed beside three
    matmuls; flash at (1, S, S, 20, 4, 128) for each of phase 5b's
    prefill buckets, timed beside SDPA. At tp 4 and 8: the three at T =
    256 (flash at S 256), untimed. The MLP's weights are a rank's blocks
    of the init-scale full weights (``wo`` / ``w_down`` at 0.02 /
    sqrt(80)). Inputs come from a generator of their own. Returns
    {kernel name: records}."""
    rng = np.random.default_rng(seed + 1913)
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    bf = torch.bfloat16
    out = {"paged_attention": {}, "fused_mlp": {}, "flash_attention": {}}
    for degree, (heads, d, f) in TP_SHAPES.items():
        timed = degree == TP_DEGREE
        tag = f"Qwen3-14B tp {degree}"
        cases = [("T256", dict(rows=MIX_T256), (slice(3, None), 5), timed)]
        if timed:
            cases.append(("split", dict(rows=MIX_SPLIT), (2, 10), True))
        out["paged_attention"][degree] = _paged_cases(rng, heads, 128, cases,
                                                      tag)
        wg = (torch.randn((d, f), generator=gen, device="cuda")
              * 0.02).to(bf)
        wu = (torch.randn((d, f), generator=gen, device="cuda")
              * 0.02).to(bf)
        wd = (torch.randn((f, d), generator=gen, device="cuda")
              * (0.02 / math.sqrt(80))).to(bf)
        rows = sorted(set(MLP_SPLIT_ROWS) | {256}) if timed else [256]
        out["fused_mlp"][degree] = [
            _mlp_rows(gen, t, wg, wu, wd, 1e-3, 8e-3, timed=timed)
            for t in rows]
        del wg, wu, wd
        hq, hkv = heads
        lens = [n for (_, n, *_) in FLASH_SPLIT_SHAPES] if timed else [256]
        out["flash_attention"][degree] = [
            _flash_shape(gen, (1, n, n, hq, hkv, 128), 1e-5, 8e-3,
                         timed=timed) for n in sorted(set(lens))]
        torch.cuda.empty_cache()
    return out


def _tp_rank_setup():
    """A rank on the one card: cuda:0, TF32 off (the f32 parity)."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


#: phase 4's tp run: phase 4's tiny f32 dense config, and the layouts two
#: gloo ranks serve it on (engine keywords)
TP_PARITY_CFG = dict(name="pal-dense", arch_type="dense", num_layers=2,
                     d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                     vocab_size=128, dtype="float32")
TP_PARITY_LAYOUTS = {"mixed": dict(chunk_tokens=16),
                     "split": dict(mixed=False)}


def _tp_parity_rank(rank: int, world: int, flat, prompts):
    """One rank of phase 4's tp run: the tiny f32 dense config sharded
    over ``world`` ranks on cuda:0 (gloo), on each of
    ``TP_PARITY_LAYOUTS``; kernel launches counted from 0 just before
    each run."""
    from repro_torch import kernels
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.strategy import Strategy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.params import from_numpy
    from repro_torch.serve.engine import ServeEngine
    _tp_rank_setup()
    cfg = ModelConfig(**TP_PARITY_CFG)
    mesh = make_mesh((1, world), ("data", "model"))
    params = from_numpy(flat, cfg, "cuda", shard=(Strategy(dtype=cfg.dtype),
                                                  mesh))
    out = {}
    for name, kw in TP_PARITY_LAYOUTS.items():
        eng = ServeEngine(cfg, params, slots=2, max_len=64, mesh=mesh, **kw)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=6)
        kernels.reset_launches()
        res = eng.run()
        out[name] = {"streams": {i: list(res[i].out) for i in res},
                     "launches": kernels.launches(),
                     "want": _want_launches(eng, cfg.num_layers),
                     "decode_traces": eng.stats["decode_traces"],
                     "backend": eng.stats["decode_backend"],
                     "per_device": eng.per_device_kv_bytes(),
                     "kv_bytes": eng.kv_bytes(), "tp": eng.tp,
                     "collectives": dict(eng._rank.counts)}
    # the mixed step online: a driver on each rank, rank 0 submitting
    # before the start
    kernels.reset_launches()
    eng = ServeEngine(cfg, params, slots=2, max_len=64, mesh=mesh,
                      **TP_PARITY_LAYOUTS["mixed"])
    out["online"] = _online_run(eng, prompts, 6)
    out["online"]["want"] = _want_launches(eng, cfg.num_layers)
    return out


def _online_run(backend, prompts, max_new: int, timeout: float = 240.0):
    """``prompts`` through an ``AsyncDriver`` over ``backend`` on this
    rank (rank 0 submits, then every rank starts and stops it): rank 0's
    streams, this rank's launches since the caller zeroed them, and the
    loop's fault."""
    from repro_torch import kernels
    from repro_torch.serve.driver import AsyncDriver
    drv = AsyncDriver(backend, start=False)
    live = [drv.submit(p, max_new=max_new, rid=i)
            for i, p in enumerate(prompts)] if drv.lead else []
    drv.start()
    streams = {s.rid: list(s.result(timeout=timeout).out) for s in live}
    drv.stop(timeout=timeout)
    return {"streams": streams, "launches": kernels.launches(),
            "lead": drv.lead, "error": repr(drv.error)}


def _rank_env(world: int) -> dict:
    """The environment of ``world`` rank processes sharing the host and
    the card: the host's cores split between them (``OMP_NUM_THREADS``,
    as ``torchrun`` sets it), and the caching allocator's expandable
    segments, so that memory a rank frees between its runs goes back to
    the card for the next rank's (a freed block inside a segment with one
    live block would otherwise stay reserved); either left as the caller's
    environment sets it."""
    env = {"OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // world)),
           "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    return {k: os.environ.get(k, v) for k, v in env.items()}


def _spawn_ranks(fn, args, timeout: float, tag: str,
                 world: int = TP_DEGREE):
    """``fn`` on ``world`` rank processes sharing cuda:0 over gloo
    (``launch/ranks.py``, ``_rank_env``), their store in ``chiprun_out/``;
    a rank's failure or timeout fails the phase."""
    from repro_torch.launch.ranks import run_ranks
    store = ROOT / "chiprun_out"
    store.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    outs = run_ranks(fn, world, args=args, backend="gloo",
                     store_dir=str(store), timeout=timeout,
                     env=_rank_env(world))
    log(f"[{tag}] {world} rank processes done in "
        f"{time.perf_counter() - t0:.1f}s")
    return outs


class RankJob(NamedTuple):
    """What a phase on rank processes asks for: ``fn(rank, world,
    *args)`` on ``world`` ranks within ``timeout`` seconds. A phase
    function yields one and gets the ranks' results back (``_run_jobs``)."""
    fn: Callable
    args: tuple
    timeout: float
    tag: str
    world: int = TP_DEGREE


def _rank_jobs(rank: int, world: int, jobs):
    """Each of ``jobs`` ((fn, args, tag)) in turn on this rank process,
    the card's memory freed and its peak reset before each: their
    results, in order, and the host's clock (``time.time``) at the first
    job's start and the last one's end."""
    outs, first = [], time.time()
    for fn, args, tag in jobs:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs.append(fn(rank, world, *args))
        if rank == 0:
            print(f"[{tag}] done in {time.perf_counter() - t0:.1f}s of the "
                  f"rank processes", flush=True)
    return {"outs": outs, "wall": (first, time.time())}


def _start(phase):
    """Run the generator ``phase`` up to the ``RankJob`` it yields."""
    return phase, next(phase)


def _run_jobs(started: dict, tag: str) -> dict:
    """The ``RankJob`` of every phase in ``started`` ({key: ``_start``'s
    pair}, one world size) on one set of rank processes, in order (a
    process's start costs seconds); then each phase resumed with its
    ranks' results, to its checks and its record: {key: record}."""
    jobs = [job for _, job in started.values()]
    world = jobs[0].world
    check(all(job.world == world for job in jobs),
          f"[{tag}] world sizes {[job.world for job in jobs]}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    got = _spawn_ranks(_rank_jobs,
                       ([(job.fn, job.args, job.tag) for job in jobs],),
                       sum(job.timeout for job in jobs), tag, world=world)
    t1 = time.time()
    first = max(r["wall"][0] for r in got)
    last = min(r["wall"][1] for r in got)
    log(f"[{tag}] the processes' start took {first - t0:.1f}s (the last "
        f"rank's first job), their jobs {last - first:.1f}s, their end "
        f"{t1 - last:.1f}s (from the first rank's last job)")
    outs = [r["outs"] for r in got]
    records = {}
    for i, (key, (phase, _)) in enumerate(started.items()):
        try:
            phase.send([ranks[i] for ranks in outs])
        except StopIteration as stop:
            records[key] = stop.value
        else:
            raise RuntimeError(f"[{tag}] {key} asked for ranks twice")
    return records


def phase_parity_tp():
    """The tiny f32 dense config (Hkv 2: one K/V head a rank) served by
    two tensor-parallel ranks sharing the card over gloo, on the mixed
    step and the split path on the pool, against the unsharded engine on
    the card: streams identical, one program shape, the per-rank KV bytes
    half of the unsharded engine's, every kernel launched as
    ``_want_launches`` says on each rank, and one all-reduce after ``wo``
    and one after ``w_down`` a layer a program; then the mixed step
    online (``AsyncDriver`` on both ranks, rank 0 submitting): rank 0's
    streams equal the lockstep streams, launches as the path says."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(**TP_PARITY_CFG)
    params = init_params(cfg, device="cuda", seed=3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, size=(n,)).astype(np.int32)
               for n in (5, 23, 9, 40, 6)]
    base = {}
    for name, kw in TP_PARITY_LAYOUTS.items():
        eng = ServeEngine(cfg, params, slots=2, max_len=64, **kw)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=6)
        res = eng.run()
        base[name] = ({i: list(res[i].out) for i in res},
                      eng.per_device_kv_bytes())
    flat = {k: v.cpu().numpy() for k, v in flatten(params).items()}
    ranks = yield RankJob(_tp_parity_rank, (flat, prompts), 240.0,
                          "parity tp 2")
    out = {}
    for name in TP_PARITY_LAYOUTS:
        want_streams, want_kv = base[name]
        for r, got in enumerate(ranks):
            run = got[name]
            check(run["streams"] == want_streams,
                  f"[parity tp {name}] rank {r} streams {run['streams']} != "
                  f"the unsharded engine's {want_streams}")
            check(run["launches"] == run["want"] and run["backend"] ==
                  "kernel", f"[parity tp {name}] rank {r} launches "
                  f"{run['launches']} != {run['want']}")
            check(run["decode_traces"] == 1,
                  f"[parity tp {name}] decode_traces {run['decode_traces']}")
            check(run["per_device"] * 2 == want_kv
                  and run["kv_bytes"] == want_kv,
                  f"[parity tp {name}] per-rank KV {run['per_device']} B, "
                  f"global {run['kv_bytes']} B; unsharded {want_kv} B")
            coll = run["collectives"]
            check(coll["attn_out"] == coll["mlp_out"]
                  == cfg.num_layers * coll["tokens"],
                  f"[parity tp {name}] rank {r} collectives {coll}")
        run = ranks[0][name]
        log(f"[parity tp 2, f32] {name}: both ranks' streams equal the "
            f"unsharded engine's on the card over {len(prompts)} requests; "
            f"decode_traces 1; KV {run['per_device']} B a rank = half of "
            f"{want_kv} B; launches a rank {run['launches']}; collectives "
            f"a rank {run['collectives']}")
        out[name] = {k: ranks[0][name][k] for k in
                     ("launches", "per_device", "kv_bytes", "collectives")}
        out[name]["unsharded_kv_bytes"] = want_kv
    lockstep = ranks[0]["mixed"]["streams"]
    check(ranks[0]["online"]["streams"] == lockstep,
          f"[parity tp online] rank 0's driver streams "
          f"{ranks[0]['online']['streams']} != the lockstep {lockstep}")
    for r, got in enumerate(ranks):
        run = got["online"]
        check(run["error"] == "None" and run["lead"] == (r == 0),
              f"[parity tp online] rank {r}: {run['error']}")
        check(run["launches"] == run["want"],
              f"[parity tp online] rank {r} launches {run['launches']} != "
              f"{run['want']}")
    log(f"[parity tp 2 online, f32] rank 0's driver streams equal the "
        f"lockstep mixed streams over {len(prompts)} requests; launches a "
        f"rank {ranks[0]['online']['launches']}")
    out["online"] = {"launches": ranks[0]["online"]["launches"]}
    return out


def _tp_serve_rank(rank: int, world: int, seed: int, prompts, max_new: int):
    """One rank of phase 19: Qwen3-14B through ``Session.serve(tp=)`` on
    the mixed step, then the same rank shards on the split path; each run
    timed step by step with its launches counted from 0 just before and
    read just after, and checked as phase 5 / 5b check theirs."""
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.serve.paging import pages_for
    from repro_torch.serve.step import page_bucket, prefill_bucket
    torch.cuda.set_device(0)
    cfg = get_config("qwen3-14b").with_(num_layers=TP_SERVE_LAYERS)
    layers = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = Session(cfg, device="cuda", seed=seed)
    eng = session.serve(tp=world, slots=4, max_len=1024, page_size=16,
                        chunk_tokens=256)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights_gb = sum(v.numel() * v.element_size() for v in
                     _leaves(eng.params)) / 1e9
    out = {"rank": rank, "build_s": build_s, "weights_gb": weights_gb,
           "heads": [eng._rank.heads, eng._rank.kv_heads]}
    lens = [len(p) for p in prompts]
    buckets = {page_bucket(max(pages_for(min(n + max_new - 1, 1024), 16)
                               for n in lens[:i + 1]), cap=64)
               for i in range(len(lens))}
    split_buckets = {prefill_bucket(n, cap=1024) for n in lens}
    params = eng.params
    for name in ("mixed", "split"):
        if name == "split":
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            eng = Session(cfg, device="cuda", params=params).serve(
                tp=world, slots=4, max_len=1024, page_size=16, mixed=False)
        for rid, p in enumerate(prompts):
            eng.submit(rid, p, max_new=max_new)
        kernels.reset_launches()
        eng._rank.counts.clear()
        step_s = []
        t0 = time.perf_counter()
        while eng.busy():
            s0 = time.perf_counter()
            eng.step()
            step_s.append(time.perf_counter() - s0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        res = eng.results()
        for rid in range(len(prompts)):
            r = res[rid]
            check(r.done and len(r.out) == max_new
                  and all(0 <= t < cfg.vocab_size for t in r.out),
                  f"[tp {name}] rank {rank} request {rid} finished={r.done} "
                  f"with {len(r.out)} tokens")
        want = _want_launches(eng, layers)
        check(counts == want, f"[tp {name}] rank {rank} launches {counts} "
                              f"!= {want}")
        if name == "mixed":
            check(eng.stats["decode_traces"] <= len(buckets),
                  f"[tp mixed] {eng.stats['decode_traces']} program shapes")
        else:
            check(eng.stats["decode_traces"] == 1
                  and eng.stats["prefill_traces"] == len(split_buckets),
                  f"[tp split] traces {eng.stats['decode_traces']} / "
                  f"{eng.stats['prefill_traces']}")
        check(bool(torch.isfinite(eng.last_logits).all()),
              f"[tp {name}] rank {rank}: finite logits")
        tokens = sum(len(res[r].out) for r in res)
        step_ms = np.asarray(step_s) * 1e3
        out[name] = {"tokens": tokens, "wall_s": wall,
                     "tokens_per_s": tokens / wall, "steps": len(step_s),
                     "step_p50_ms": float(np.percentile(step_ms, 50)),
                     "step_max_ms": float(step_ms.max()),
                     "launches": counts,
                     "collectives": dict(eng._rank.counts),
                     "decode_traces": eng.stats["decode_traces"],
                     "prefill_traces": eng.stats["prefill_traces"],
                     "per_device_kv_bytes": eng.per_device_kv_bytes(),
                     "kv_bytes": eng.kv_bytes(),
                     "streams": [list(res[r].out)
                                 for r in range(len(prompts))]}
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del eng                               # phase 26 builds its own engines
    gc.collect()
    torch.cuda.empty_cache()
    out["online"] = _online_tp_rank(rank, cfg, params, prompts, max_new)
    return out


#: phase 26's engine settings (phase 5's) and the seconds a request or a
#: client may wait
ONLINE_TP_KW = dict(slots=4, max_len=1024, page_size=16, chunk_tokens=256)
ONLINE_TP_WAIT_S = 600.0


def _online_tp_rank(rank: int, cfg, params, prompts, max_new: int):
    """Phase 26 on one rank of phase 19, on its shards: run A (deferred
    start, rank 0 submits) and run B (HTTP on rank 0), each with the
    launches zeroed just before its engine is built and read after its
    loop ended; the engine counters, the control channel's tallies and
    this rank's peak memory. The checks are ``phase_online_tp``'s."""
    import threading
    import urllib.request
    from repro_torch import kernels
    from repro_torch.api import Session
    session = Session(cfg, device="cuda", params=params)
    torch.cuda.reset_peak_memory_stats()
    out = {}

    def record(drv, wall, tokens):
        eng = drv.engine
        chan = drv._chan
        lat = drv.metrics.latency_summary()
        step = drv.metrics.step_latency
        return {"lead": drv.lead, "error": repr(drv.error),
                "launches": kernels.launches(),
                "want": _want_launches(eng, cfg.num_layers),
                "stats": {k: eng.stats[k] for k in (
                    "step_count", "mixed_steps", "decode_steps",
                    "decode_tokens", "prefills", "decode_traces",
                    "peak_pages", "preemptions", "expired")},
                "passes": chan.passes, "channel_s": chan.seconds,
                "events": eng._rank.counts["driver_events"],
                "events_bytes": eng._rank.bytes["driver_events"],
                "collectives": dict(eng._rank.counts),
                "steps": step.count,
                "step_p50_ms": step.quantile(0.5) * 1e3,
                "latency": lat, "wall_s": wall, "tokens": tokens,
                "tokens_per_s": tokens / wall if wall else None}

    # run A: deferred start, the streams of phase 19's mixed run
    kernels.reset_launches()
    drv = session.serve_async(tp=TP_DEGREE, start=False,
                              watchdog_timeout=120.0, **ONLINE_TP_KW)
    live = [drv.submit(p, max_new=max_new, rid=i)
            for i, p in enumerate(prompts)] if drv.lead else []
    t0 = time.perf_counter()
    drv.start()
    streams = [list(s.result(timeout=ONLINE_TP_WAIT_S).out) for s in live]
    wall = time.perf_counter() - t0
    drv.stop(timeout=ONLINE_TP_WAIT_S)
    torch.cuda.synchronize()
    out["A"] = dict(record(drv, wall, sum(map(len, streams))),
                    streams=streams)
    del drv, live
    gc.collect()
    torch.cuda.empty_cache()

    # run B: HTTP on rank 0, six client threads while the loop runs
    kernels.reset_launches()
    server = session.serve_http(tp=TP_DEGREE, port=0, watchdog_timeout=120.0,
                                **ONLINE_TP_KW)
    bodies, errors, http = {}, [], {}

    def client(i):
        try:
            body = {"prompt": [int(t) for t in prompts[i]],
                    "max_new": max_new, "timeout": ONLINE_TP_WAIT_S,
                    "stream": i == 0}
            with _post_json(f"{server.url}/generate", body,
                            ONLINE_TP_WAIT_S) as r:
                if i == 0:
                    lines = [json.loads(ln) for ln in r if ln.strip()]
                    bodies[i] = {"tokens": [ln["token"]
                                            for ln in lines[:-1]],
                                 "closing": lines[-1]}
                else:
                    bodies[i] = json.loads(r.read())
        except Exception as exc:       # reported below, fails the phase
            errors.append(f"request {i}: {exc!r}")

    wall = 0.0
    try:
        if server.driver.lead:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=ONLINE_TP_WAIT_S)
            wall = time.perf_counter() - t0
            errors += [f"client {i} hung" for i, t in enumerate(threads)
                       if t.is_alive()]
            with urllib.request.urlopen(f"{server.url}/metrics",
                                        timeout=60) as r:
                http["metrics"] = r.read().decode()
            with urllib.request.urlopen(f"{server.url}/healthz",
                                        timeout=60) as r:
                http["health"] = json.loads(r.read())
    finally:
        server.close(drain=False)
    torch.cuda.synchronize()
    toks = [bodies[i]["tokens"] for i in sorted(bodies)]
    out["B"] = dict(record(server.driver, wall, sum(map(len, toks))),
                    tokens_by_request=toks, errors=errors,
                    closing=bodies.get(0, {}).get("closing"), **http)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def phase_tp_serve(seed: int, main_run: dict, max_new: int = 16):
    """Phase 19: full-width Qwen3-14B, depth cut to ``TP_SERVE_LAYERS``
    (5 of 40), served tensor-parallel at tp 2 by two rank processes
    sharing the card over gloo (``Session.serve(tp=2)`` in each; each rank
    draws only its shards: 20/4 heads x 128 and d_ff 8704 of every layer,
    half the vocabulary), phase 5's settings and six prompts on the mixed
    step, then the split path on the same shards. Checks on each rank as
    phase 5 and 5b check theirs; the per-rank KV bytes must be half of
    phase 5's pool's share of its layers. Prints tokens/s, step p50 and
    each rank's peak memory. Two ranks share one card's SMs and gloo
    stages every all-reduce through host memory: these numbers are not
    tensor parallelism's speed."""
    from repro_torch.configs import get_config
    _, prompts = serving_prompts(seed, get_config("qwen3-14b").vocab_size)
    prompts = [np.asarray(p, np.int32) for p in prompts]
    ranks = yield RankJob(_tp_serve_rank, (seed, prompts, max_new),
                          TP_TIMEOUT_S, "tp serve")
    note = ("two ranks share one card's SMs and gloo stages each "
            "all-reduce through host memory: not tensor parallelism's "
            "speed")
    out = {"note": note, "ranks": []}
    for r in ranks:
        kv = r["mixed"]["per_device_kv_bytes"]
        check(kv * 2 * main_run["layers"]
              == main_run["kv_bytes"] * TP_SERVE_LAYERS,
              f"[tp serve] rank {r['rank']} KV {kv} B x 2 != phase 5's "
              f"{main_run['kv_bytes']} B x {TP_SERVE_LAYERS} / "
              f"{main_run['layers']} layers")
        for name in ("mixed", "split"):
            check(r[name]["streams"] == ranks[0][name]["streams"],
                  f"[tp serve {name}] rank {r['rank']} streams differ from "
                  f"rank 0's")
        out["ranks"].append({k: v for k, v in r.items()})
    r0 = ranks[0]
    for name in ("mixed", "split"):
        run = r0[name]
        log(f"[tp serve {name}] Qwen3-14B {TP_SERVE_LAYERS} layers tp 2 "
            f"({r0['heads'][0]}/"
            f"{r0['heads'][1]} heads a rank, {r0['weights_gb']:.2f} GB of "
            f"weights a rank, built in {r0['build_s']:.1f}s): "
            f"{run['tokens']} tokens in {run['wall_s']:.2f}s = "
            f"{run['tokens_per_s']:.2f} tok/s, {run['steps']} steps, step "
            f"p50 {run['step_p50_ms']:.1f} ms (max {run['step_max_ms']:.1f}"
            f"); peak memory a rank "
            f"{[round(x['peak_mem_gb'], 2) for x in ranks]} GB; KV "
            f"{run['per_device_kv_bytes'] / 1e9:.3f} GB a rank of "
            f"{run['kv_bytes'] / 1e9:.3f} GB; launches a rank "
            f"{run['launches']}; collectives a rank {run['collectives']} — "
            f"{note}")
    out["mixed"], out["split"] = r0["mixed"], r0["split"]
    return out


def phase_online_tp(ranks, lockstep: dict, smi: str, max_new: int = 16):
    """Phase 26's checks and report on each rank's ``_online_tp_rank``
    (``ranks``, each with its ``"rank"``) against phase 19's record
    (``lockstep``): run A's streams equal to phase 19's mixed streams bit
    for bit, launches as the path says on each rank, ``decode_traces``
    within phase 19's; run B's six responses with ``max_new`` tokens each
    (the chunked one's closing record too), ``serve_ttft_seconds_count``
    6, the follower's engine counters equal to rank 0's. Reports
    tokens/s, step p50, TTFT / TPOT p50 / p90, the control channel a
    pass, peak memory a rank and run B's share of tokens equal to phase
    19's (not checked: arrival order changes the batches)."""
    note = ("two ranks share one card's SMs over gloo: not tensor "
            "parallelism's speed")
    r0 = ranks[0]
    base = lockstep["mixed"]["streams"]
    n = len(base)
    check(r0["A"]["lead"] and not any(r["A"]["lead"] for r in ranks[1:]),
          "[online tp] rank 0 leads")
    check(r0["A"]["streams"] == base,
          f"[online tp A] rank 0's driver streams differ from phase 19's "
          f"mixed lockstep streams: {r0['A']['streams']} != {base}")
    for r in ranks:
        for run in ("A", "B"):
            got = r[run]
            tag = f"[online tp {run}] rank {r['rank']}"
            check(got["error"] == "None", f"{tag}: {got['error']}")
            check(got["launches"] == got["want"],
                  f"{tag} launches {got['launches']} != {got['want']}")
            check(got["stats"] == r0[run]["stats"],
                  f"{tag} engine counters {got['stats']} != rank 0's "
                  f"{r0[run]['stats']}")
            check(got["events"] == 2 * got["passes"],
                  f"{tag} {got['events']} event broadcasts for "
                  f"{got['passes']} passes")
        check(r["A"]["stats"]["decode_traces"]
              <= lockstep["mixed"]["decode_traces"],
              f"[online tp A] rank {r['rank']} decode_traces "
              f"{r['A']['stats']['decode_traces']} > phase 19's")
    b = r0["B"]
    toks = b["tokens_by_request"]
    check(not b["errors"] and len(toks) == n
          and all(len(t) == max_new for t in toks),
          f"[online tp B] responses {[len(t) for t in toks]}, errors "
          f"{b['errors']}")
    check(b["closing"] is not None and b["closing"].get("done") is True
          and b["closing"]["tokens"] == toks[0],
          "[online tp B] the streamed response's closing record")
    check(f"serve_ttft_seconds_count {n}" in b["metrics"],
          f"[online tp B] serve_ttft_seconds_count != {n}")
    check(b["health"]["status"] == "ok", f"[online tp B] /healthz "
                                         f"{b['health']}")
    b["tokens_equal_to_phase19"] = sum(
        a == w for g, ws in zip(toks, base) for a, w in zip(g, ws)) / (
        max_new * n)
    out = {"note": note, "ranks": ranks}
    for run in ("A", "B"):
        got = r0[run]
        lat = got["latency"]
        per_pass_ms = got["channel_s"] * 1e3 / max(got["passes"], 1)
        got["channel"] = {
            "broadcasts_a_pass": got["events"] / max(got["passes"], 1),
            "bytes_a_pass": got["events_bytes"] / max(got["passes"], 1),
            "ms_a_pass": per_pass_ms}
        extra = "" if run == "A" else (
            f"; {b['tokens_equal_to_phase19']:.1%} of tokens equal to "
            f"phase 19's streams (reported)")
        log(f"[online tp {run}] Qwen3-14B tp 2 on {smi}: "
            f"{got['tokens']} tokens in {got['wall_s']:.2f}s = "
            f"{got['tokens_per_s']:.2f} tok/s, {got['steps']} steps, step "
            f"p50 {got['step_p50_ms']:.1f} ms (phase 19 mixed "
            f"{lockstep['mixed']['step_p50_ms']:.1f}); TTFT p50 "
            f"{lat['ttft_p50_s']:.3f} s, p90 {lat['ttft_p90_s']:.3f} s; "
            f"TPOT p50 {lat['tpot_p50_s'] * 1e3:.1f} ms, p90 "
            f"{lat['tpot_p90_s'] * 1e3:.1f} ms; control channel "
            f"{got['passes']} passes, {got['channel']['broadcasts_a_pass']:.1f}"
            f" broadcasts and {got['channel']['bytes_a_pass']:.1f} B a pass, "
            f"{per_pass_ms:.2f} ms a pass on rank 0; launches a rank "
            f"{got['launches']}; peak memory a rank "
            f"{[round(r['peak_mem_gb'], 2) for r in ranks]} GB{extra} — "
            f"{note}")
    out["A"], out["B"] = r0["A"], r0["B"]
    return out


# ------------------------------------- phases 3, 4, 20-22: dp and tp slices

#: the rank shapes of phases 21 and 22 (tp 2): OLMoE-1B-7B's 8/8 heads x
#: 128 and whisper-tiny's 3/3 x 64 a rank
OLMOE_TP2_HEADS = (MOE_HEADS[0] // 2, MOE_HEADS[1] // 2)
WHISPER_TP2_HEADS = (WHISPER_HEADS[0] // 2, WHISPER_HEADS[1] // 2)
#: the seconds phases 21 and 22's two rank processes may take
FAMILY_TP_TIMEOUT_S = 480.0


def olmoe_tp2_flash_shapes(seed: int):
    """Flash's shapes on phase 21's split path at ``seed``: one (1, S, S,
    8, 8, 128) a distinct prompt length of phase 5's six (an MoE prefill
    is not bucketed)."""
    lens, _ = serving_prompts(seed, 2)
    hq, hkv = OLMOE_TP2_HEADS
    return tuple((1, n, n, hq, hkv, 128) for n in sorted({int(n)
                                                          for n in lens}))


def whisper_tp2_flash_shapes(seed: int):
    """Flash's shapes on phase 22 at ``seed``, (B, S, T, Hq, Hkv, D,
    causal): the encoder non-causal over 1500 frames at an admission (B
    1) and at B 8, and the decoder causal at each distinct prompt length
    of phase 22's split path, 3/3 heads x 64 a rank."""
    hq, hkv = WHISPER_TP2_HEADS
    return tuple(shape[:3] + (hq, hkv) + shape[5:]
                 for shape in whisper_flash_shapes(seed)
                 if shape[2] != WHISPER_TRAIN)


def phase_tp_family_kernels(seed: int):
    """Paged attention and flash in bf16 at the rank shapes of phases 21
    (OLMoE-1B-7B at tp 2: 8/8 heads x 128) and 22 (whisper-tiny at tp 2:
    3/3 x 64): paged attention (``_paged_cases``) at OLMoE's T = 256 mix
    and 4-row split decode table, at whisper-tiny's T = 256 mix over 8
    slots x 448 and its 8-row split decode table; flash at
    ``olmoe_tp2_flash_shapes`` and ``whisper_tp2_flash_shapes`` (the
    encoder non-causal, each shown to reject a version that drops the last
    key tile; the decoder causal). Each per value against its plain
    version with its defect rejected, timed beside SDPA with its bound.
    Inputs come from a generator of their own. Returns {kernel name:
    {"olmoe_tp2": records, "whisper_tp2": records}}."""
    rng = np.random.default_rng(seed + 2122)
    paged = {"olmoe_tp2": _paged_cases(rng, OLMOE_TP2_HEADS, 128, (
        ("T256", dict(rows=MIX_T256), (slice(3, None), 5), True),
        ("split", dict(rows=MIX_SPLIT), (2, 10), True)), "OLMoE tp 2")}
    split = (list(range(8)), list(WHISPER_DECODE[1][:8]))
    paged["whisper_tp2"] = _paged_cases(rng, WHISPER_TP2_HEADS, WHISPER_D, (
        ("T256", dict(rows=WHISPER_T256), (slice(7, 231), 5), True),
        ("split", dict(rows=split), (4, 12), True)), "whisper-tiny tp 2",
        gather_atol=None, ctx=WHISPER_CTX, width=28, n_pages=225)
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    flash = {"olmoe_tp2": [_flash_shape(gen, shape, 1e-5, 8e-3, timed=True)
                           for shape in olmoe_tp2_flash_shapes(seed)],
             "whisper_tp2": [_flash_shape(gen, shape[:6], 1e-5, 8e-3,
                                          timed=True, causal=shape[6])
                             for shape in whisper_tp2_flash_shapes(seed)]}
    return {"paged_attention": paged, "flash_attention": flash}


#: phase 4's tp families: tests/test_serve_parallel.py's MOE_CFG (at
#: capacity factor 2.0, phase 4's no-drop MoE setting) and AUDIO_CFG, and
#: the layouts two gloo ranks serve each on
TP_FAMILY_PARITY = {
    "moe": dict(name="pal-moe", arch_type="moe", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, num_experts=4,
                experts_per_token=2, vocab_size=128,
                moe_capacity_factor=2.0, dtype="float32"),
    "audio": dict(name="pal-encdec", arch_type="audio", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
                  vocab_size=128, encoder_layers=1, encoder_ctx=12,
                  dtype="float32"),
    # AUDIO_CFG with one K/V head: 1 does not divide tp 2, so on the
    # split path's dense rows each rank holds its slice of the decoder's
    # and the encoder's positions with the one head (the reference's
    # cache_pspecs), decoded context-parallel
    "audio_kv1": dict(name="pal-encdec-kv1", arch_type="audio",
                      num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
                      d_ff=128, vocab_size=128, encoder_layers=1,
                      encoder_ctx=12, dtype="float32"),
    # tests/test_serve_engine.py's SSM_CFG (chunk 64: phase 4's prompts
    # are single chunks), and a hybrid of one group of two Mamba layers
    # and the shared block, then one trailing layer
    "ssm": dict(name="pal-ssm", arch_type="ssm", num_layers=2, d_model=64,
                num_heads=0, num_kv_heads=0, d_ff=128, ssm_state=16,
                ssm_heads=4, ssm_head_dim=16, ssm_chunk=64, vocab_size=128,
                dtype="float32"),
    "hybrid": dict(name="pal-hybrid", arch_type="hybrid", num_layers=3,
                   d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
                   ssm_state=16, ssm_heads=4, ssm_head_dim=16, ssm_chunk=64,
                   hybrid_attn_every=2, vocab_size=128, dtype="float32")}
#: the MoE again with TP inside each expert (``expert_parallel=False``):
#: all four experts and half of each expert's d_ff a rank, one (T, d)
#: ``moe_out`` sum a layer, k = 2 times fewer bytes than the "moe" entry's
TP_FAMILY_PARITY["moe_tie"] = TP_FAMILY_PARITY["moe"]
#: a family's Strategy keywords where they are not the default
TP_FAMILY_STRATEGY = {"moe_tie": dict(expert_parallel=False)}


def _family_layouts(family: str) -> dict:
    """The layouts phase 4 serves a tp family on: the SSM family and the
    hybrid have one (the split path on dense rows), and so does the
    one-K/V-head enc-dec (the split path on dense rows, its sequence
    slices)."""
    if family == "audio_kv1":
        return {"dense": dict(paged=False, mixed=False)}
    return {"split": {}} if family in ("ssm", "hybrid") \
        else TP_PARITY_LAYOUTS


def _family_requests(cfg, seed: int = 3):
    """Phase 4's five prompts below ``cfg``'s vocabulary, and each one's
    frames on an enc-dec config (else None)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (5, 23, 9, 40, 6)]
    frames = list(rng.standard_normal(
        (len(prompts), cfg.encoder_ctx, cfg.d_model), dtype=np.float32)) \
        if cfg.arch_type == "audio" else None
    return prompts, frames


def _family_want(eng, cfg) -> dict:
    if cfg.arch_type in ("ssm", "hybrid"):
        return _ssm_family_want(cfg)(cfg, eng.stats["prefills"],
                                     eng.stats["decode_steps"])
    return _audio_want(eng, cfg) if cfg.arch_type == "audio" \
        else _moe_want(eng, cfg.num_layers)


def _serve_run(eng, prompts, frames, max_new: int = 6):
    """Submit, count launches from 0, run; (streams, launches)."""
    from repro_torch import kernels
    for i, p in enumerate(prompts):
        eng.submit(i, p, max_new=max_new,
                   frames=None if frames is None else frames[i])
    kernels.reset_launches()
    res = eng.run()
    return {i: list(res[i].out) for i in res}, kernels.launches()


def _tp_family_parity_rank(rank: int, world: int, flats):
    """One rank of phase 4's tp families: each of ``TP_FAMILY_PARITY``
    sharded over ``world`` ranks on cuda:0 (gloo) on the mixed step and
    the split path (``TP_PARITY_LAYOUTS``)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import tp
    from repro_torch.core.strategy import Strategy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.params import from_numpy
    from repro_torch.serve.engine import ServeEngine
    _tp_rank_setup()
    mesh = make_mesh((1, world), ("data", "model"))
    out = {}
    for family, kw in TP_FAMILY_PARITY.items():
        cfg = ModelConfig(**kw)
        params = from_numpy(flats[family], cfg, "cuda")
        prompts, frames = _family_requests(cfg)
        st = Strategy(dtype=cfg.dtype, **TP_FAMILY_STRATEGY.get(family, {}))
        for name, lkw in _family_layouts(family).items():
            eng = ServeEngine(cfg, params, slots=2, max_len=64, mesh=mesh,
                              strategy=st, **lkw)
            streams, launches = _serve_run(eng, prompts, frames)
            out[family, name] = {
                "streams": streams, "launches": launches,
                "want": _family_want(eng, cfg),
                "decode_traces": eng.stats["decode_traces"],
                "per_device": eng.per_device_kv_bytes(),
                "kv_bytes": eng.kv_bytes(), "state": _state_bytes(eng),
                "programs": eng.stats["prefills"]
                + eng.stats["decode_steps"],
                "slices": sum(isinstance(v, tp.SeqSlice)
                              for v in eng._cache.values()),
                "w_up": tuple(eng.params["layers"]["moe"]["w_up"].shape)
                if cfg.is_moe else None,
                "collectives": dict(eng._rank.counts),
                "collective_bytes": dict(eng._rank.bytes)}
    return out


def phase_parity_tp_families():
    """The reference tests' tiny MoE (E 4: two experts a rank) and enc-dec
    configs in f32 (TF32 off) served by two tensor-parallel ranks sharing
    the card over gloo, on the mixed step and the split path, against the
    unsharded engine on the card: streams identical, one program shape,
    the KV bytes a rank half of the unsharded engine's, every kernel
    launched as ``_moe_want`` / ``_audio_want`` say on each rank, and one
    ``moe_out`` all-reduce a layer a program (MoE) or the two a layer of
    each encoder run and the three a decoder layer a program (enc-dec).
    The MoE again with TP inside each expert (``TP_FAMILY_STRATEGY``):
    every expert at half its d_ff a rank, the same checks, and its
    ``moe_out`` bytes 1/k of the expert-parallel run's on the same
    programs. The one-K/V-head enc-dec on the split path's dense rows: each
    rank's decoder K/V and cross K/V its slice of the positions with the
    head, every decode step's self- and cross-attention context-parallel
    (one ``cp_qkv``, one ``cp_xq``, two ``cp_max`` and two ``cp_sum`` a
    layer), the streams the unsharded engine's. Then the SSM family and the
    hybrid (a Mamba2 block of H / 2 whole heads a rank) on the split path:
    streams identical, every kernel launched as ``_ssm_want`` /
    ``_hybrid_want`` say, the SSM states a rank half of the unsharded
    engine's and ``kv_bytes`` its, one ``ssm_out`` and one ``ssm_norm`` sum
    a Mamba layer a program (the hybrid: one ``attn_out`` and one
    ``mlp_out`` an application of the shared block)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base, flats = {}, {}
    for family, kw in TP_FAMILY_PARITY.items():
        cfg = ModelConfig(**kw)
        params = init_params(cfg, device="cuda", seed=3)
        flats[family] = {k: v.cpu().numpy()
                         for k, v in flatten(params).items()}
        prompts, frames = _family_requests(cfg)
        for name, lkw in _family_layouts(family).items():
            eng = ServeEngine(cfg, params, slots=2, max_len=64, **lkw)
            base[family, name] = (_serve_run(eng, prompts, frames)[0],
                                  eng.kv_bytes(), _state_bytes(eng))
    ranks = yield RankJob(_tp_family_parity_rank, (flats,), 240.0,
                          "parity tp 2 families")
    out = {}
    for (family, name), (want, want_kv, want_state) in base.items():
        cfg = ModelConfig(**TP_FAMILY_PARITY[family])
        for r, got in enumerate(ranks):
            run = got[family, name]
            tag = f"[parity tp {family} {name}] rank {r}"
            check(run["streams"] == want, f"{tag} streams {run['streams']} "
                                          f"!= the unsharded engine's {want}")
            check(run["launches"] == run["want"],
                  f"{tag} launches {run['launches']} != {run['want']}")
            check(run["decode_traces"] == 1,
                  f"{tag} decode_traces {run['decode_traces']}")
            c, programs = run["collectives"], run["collectives"]["tokens"]
            if family in ("ssm", "hybrid"):
                check(run["state"] * 2 == want_state
                      and run["kv_bytes"] == want_kv,
                      f"{tag} SSM states {run['state']} B x 2 != "
                      f"{want_state} B or kv_bytes {run['kv_bytes']} != "
                      f"{want_kv}")
                g = cfg.hybrid_groups[0] if family == "hybrid" else 0
                check(programs == run["programs"]
                      and c["ssm_out"] == c["ssm_norm"]
                      == cfg.num_layers * programs
                      and c.get("attn_out", 0) == c.get("mlp_out", 0)
                      == g * programs, f"{tag} collectives {c}")
                continue
            check(run["per_device"] * 2 == want_kv,
                  f"{tag} KV {run['per_device']} B x 2 != {want_kv} B")
            if family in ("moe", "moe_tie"):
                ok = c["moe_out"] == c["attn_out"] \
                    == cfg.num_layers * programs and "mlp_out" not in c
                if family == "moe_tie":
                    # every expert, half its d_ff; the (T, d) sum is 1/k
                    # of the slots' (T k, d) on the same programs
                    ep = got["moe", name]
                    ok = ok and run["w_up"] == (
                        cfg.num_layers, cfg.num_experts, cfg.d_model,
                        cfg.d_ff // TP_DEGREE) and run["programs"] \
                        == ep["programs"] \
                        and run["collective_bytes"]["moe_out"] \
                        * cfg.experts_per_token \
                        == ep["collective_bytes"]["moe_out"]
            else:
                admissions = len(want)
                ok = c["mlp_out"] == cfg.encoder_layers * admissions \
                    + cfg.num_layers * programs and c["attn_out"] == \
                    cfg.encoder_layers * admissions \
                    + 2 * cfg.num_layers * programs
                if family == "audio_kv1":   # every decode step on slices
                    steps = programs - admissions
                    ok = ok and run["slices"] == 2 and c["cp_qkv"] == \
                        c["cp_xq"] == cfg.num_layers * steps and \
                        c["cp_max"] == c["cp_sum"] == \
                        2 * cfg.num_layers * steps
            check(ok, f"{tag} collectives {c}")
        run = ranks[0][family, name]
        log(f"[parity tp 2 {family}, f32] {name}: both ranks' streams equal "
            f"the unsharded engine's on the card over {len(want)} requests; "
            f"decode_traces 1; decode state {run['per_device']} B a rank "
            f"of {want_kv} B; launches a rank {run['launches']}; "
            f"collectives a rank {run['collectives']}")
        out[f"{family} {name}"] = {k: run[k] for k in
                                   ("launches", "per_device", "collectives",
                                    "collective_bytes")}
    return out


def phase_parity_dp():
    """Data parallelism on phase 4's tiny f32 dense config: a dp 2
    ``ReplicaRouter`` in this process, both replicas on cuda:0 sharing one
    set of weights, on the mixed step and the split path, against the
    single engine on the card (streams identical, both replicas prefill,
    one program shape a replica, every kernel launched as
    ``_want_launches`` says summed over the replicas); then dp 2 x tp 2
    over four rank processes sharing the card over gloo
    (``_dp_tp_parity_rank``): on every rank the union of the streams
    equals the single engine's, one program shape a replica, the KV a
    rank half of the single engine's, two disjoint rows of two ranks;
    online there (``AsyncDriver`` on each rank over the router) rank 0's
    streams equal the single engine's and each request lands on the
    lockstep router's replica; and the tiny SSM config (``TP_FAMILY_
    PARITY["ssm"]``) over the same four ranks' dp 2 x tp 2 router: the
    union of the streams equals its single engine's, both replicas
    serve, one program shape a replica, the SSD scan launched as
    ``_ssm_want`` says."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.parallel import ReplicaRouter
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(**TP_PARITY_CFG)
    params = init_params(cfg, device="cuda", seed=3)
    prompts, _ = _family_requests(cfg)
    out, base = {}, {}
    for name, lkw in TP_PARITY_LAYOUTS.items():
        eng = ServeEngine(cfg, params, slots=2, max_len=64, **lkw)
        want, _ = _serve_run(eng, prompts, None)
        want_kv = eng.per_device_kv_bytes()
        base[name] = (want, want_kv)
        router = ReplicaRouter(cfg, params, dp=2, devices=["cuda:0"] * 2,
                               slots=2, max_len=64, **lkw)
        got, launches = _serve_run(router, prompts, None)
        per = router.stats["replicas"]
        need = {}
        for e in router.engines:
            for k, v in _want_launches(e, cfg.num_layers).items():
                need[k] = need.get(k, 0) + v
        tag = f"[parity dp 2 {name}]"
        check(got == want, f"{tag} streams {got} != the single engine's "
                           f"{want}")
        check(launches == need, f"{tag} launches {launches} != {need}")
        check(all(r["prefills"] > 0 and r["decode_traces"] == 1
                  for r in per), f"{tag} replicas {per}")
        check(router.engines[0].params["embed"].data_ptr()
              == router.engines[1].params["embed"].data_ptr(),
              f"{tag} the replicas hold two copies of the weights")
        log(f"[parity dp 2, f32] {name}: the router's streams equal the "
            f"single engine's on the card over {len(prompts)} requests "
            f"(replicas {[router.replica_of(i) for i in range(len(prompts))]}"
            f"); one set of weights; launches {launches}")
        out[name] = {"launches": launches, "kv_bytes": want_kv,
                     "homes": [router.replica_of(i)
                               for i in range(len(prompts))]}
    flat = {k: v.cpu().numpy() for k, v in flatten(params).items()}
    scfg = ModelConfig(**TP_FAMILY_PARITY["ssm"])
    sparams = init_params(scfg, device="cuda", seed=3)
    sprompts, _ = _family_requests(scfg)
    swant, _ = _serve_run(ServeEngine(scfg, sparams, slots=2, max_len=64),
                          sprompts, None)
    ssm = ({k: v.cpu().numpy() for k, v in flatten(sparams).items()},
           sprompts)
    ranks = yield RankJob(_dp_tp_parity_rank, (flat, prompts, ssm), 240.0,
                          "parity dp 2 x tp 2", world=4)
    want, want_kv = base["mixed"]
    rows = ranks[0]["rows"]
    check(sorted(sum(map(list, rows), [])) == [0, 1, 2, 3]
          and not set(rows[0]) & set(rows[1]),
          f"[parity dp 2 x tp 2] rows {rows}")
    for r, got in enumerate(ranks):
        tag = f"[parity dp 2 x tp 2] rank {r}"
        check(got["streams"] == want, f"{tag} streams {got['streams']} != "
                                      f"the single engine's {want}")
        check(got["traces"] == [1, 1], f"{tag} decode_traces {got['traces']}")
        check(got["per_device"] * 2 == want_kv,
              f"{tag} KV {got['per_device']} B x 2 != {want_kv} B")
        check(got["launches"] == got["want"],
              f"{tag} launches {got['launches']} != {got['want']}")
        check(got["rows"] == rows and r in rows[got["row"]],
              f"{tag} rows {got['rows']}")
    check(ranks[0]["online"]["streams"] == want,
          f"[parity dp 2 x tp 2 online] rank 0's driver streams "
          f"{ranks[0]['online']['streams']} != the single engine's {want}")
    for r, got in enumerate(ranks):
        run = got["online"]
        tag = f"[parity dp 2 x tp 2 online] rank {r}"
        check(run["error"] == "None" and run["lead"] == (r == 0),
              f"{tag}: {run['error']}")
        check(run["homes"] == got["homes"],
              f"{tag} replicas {run['homes']} != the lockstep router's "
              f"{got['homes']}")
        check(run["launches"] == run["want"],
              f"{tag} launches {run['launches']} != {run['want']}")
    for r, got in enumerate(ranks):
        run = got["ssm"]
        tag = f"[parity dp 2 x tp 2 ssm] rank {r}"
        check(run["streams"] == swant, f"{tag} streams {run['streams']} != "
                                       f"the single engine's {swant}")
        check(run["traces"] == [1, 1] and sorted(set(run["homes"]))
              == [0, 1], f"{tag} decode_traces {run['traces']}, replicas "
                         f"{run['homes']}")
        check(run["launches"] == run["want"],
              f"{tag} launches {run['launches']} != {run['want']}")
    log(f"[parity dp 2 x tp 2 ssm, f32] every rank's union of streams "
        f"equals the single engine's over {len(sprompts)} requests "
        f"(replicas {ranks[0]['ssm']['homes']}); launches rank 0 "
        f"{ranks[0]['ssm']['launches']}; collectives rank 0 "
        f"{ranks[0]['ssm']['collectives']}")
    log(f"[parity dp 2 x tp 2 online, f32] rank 0's driver streams (row 1's "
        f"tokens returned by its root) equal the single engine's; replicas "
        f"{ranks[0]['online']['homes']} as the lockstep router's")
    log(f"[parity dp 2 x tp 2, f32] four ranks on the card over gloo, rows "
        f"{rows}: every rank's union of streams equals the single engine's "
        f"over {len(prompts)} requests; decode_traces 1 a replica; KV "
        f"{ranks[0]['per_device']} B a rank = half of {want_kv} B; "
        f"collectives rank 0 {ranks[0]['collectives']}")
    out["dp2_tp2"] = {k: ranks[0][k] for k in
                      ("rows", "per_device", "launches", "collectives")}
    return out


def _dp_tp_parity_rank(rank: int, world: int, flat, prompts, ssm):
    """One rank of phase 4's dp 2 x tp 2 run: a ``ReplicaRouter`` over a
    (2, 2) ("data", "model") mesh on cuda:0 (gloo), the mixed step, in
    lockstep and then online; then the tiny SSM config's router
    (``ssm``: its flat params and prompts) on the split path."""
    from repro_torch import kernels
    from repro_torch.configs.base import ModelConfig
    from repro_torch.params import from_numpy
    from repro_torch.serve.parallel import ReplicaRouter
    _tp_rank_setup()
    cfg = ModelConfig(**TP_PARITY_CFG)
    params = from_numpy(flat, cfg, "cuda")
    router = ReplicaRouter(cfg, params, dp=2, tp=2,
                           slots=2, max_len=64, **TP_PARITY_LAYOUTS["mixed"])
    streams, launches = _serve_run(router, prompts, None)
    eng = router.engines[0]
    out = {"streams": streams, "launches": launches,
           "want": _want_launches(eng, cfg.num_layers),
           "traces": [r["decode_traces"] for r in router.stats["replicas"]],
           "per_device": router.per_device_kv_bytes(), "row": router.row,
           "rows": router.meshes, "collectives": dict(eng._rank.counts),
           "homes": [router.replica_of(i) for i in range(len(prompts))]}
    # the same router online on the four ranks: rank 0 submits, each
    # other row's root returns its requests' tokens to rank 0
    kernels.reset_launches()
    router = ReplicaRouter(cfg, params, dp=2, tp=2,
                           slots=2, max_len=64, **TP_PARITY_LAYOUTS["mixed"])
    homes, submit = [], router.submit

    def routed(*args, **kw):
        homes.append(submit(*args, **kw))
        return homes[-1]

    router.submit = routed
    out["online"] = _online_run(router, prompts, 6)
    out["online"].update(homes=homes, want=_want_launches(
        router.engines[0], cfg.num_layers))
    scfg = ModelConfig(**TP_FAMILY_PARITY["ssm"])
    router = ReplicaRouter(scfg, from_numpy(ssm[0], scfg, "cuda"), dp=2,
                           tp=2, slots=2, max_len=64)
    streams, launches = _serve_run(router, ssm[1], None)
    eng = router.engines[0]
    out["ssm"] = {"streams": streams, "launches": launches,
                  "want": _family_want(eng, scfg),
                  "traces": [r["decode_traces"]
                             for r in router.stats["replicas"]],
                  "homes": [router.replica_of(i) for i in range(len(ssm[1]))],
                  "collectives": dict(eng._rank.counts)}
    return out


def _drive_router(router, prompts, max_new: int, tag: str, *,
                  late=None):
    """Submit ``prompts`` to ``router`` (``late``: (rid, after rid, after
    n tokens): request ``rid`` arrives once request ``after`` has ``n``
    tokens, with a 600 s deadline), zero the launch counts, step until
    every replica is idle and read them: each request finishes with
    ``max_new`` in-vocab tokens, paged attention and the fused MLP ran
    layers x program runs summed over the replicas. Before each
    submission the replicas' loads are read: a prompt whose first block
    a replica took before must land there whenever that replica's load
    was within ``slots`` of the least (the affinity). Returns the run's
    record."""
    from repro_torch import kernels
    cfg = router.cfg
    records, loads = {}, {}

    def submit(rid):
        loads[rid] = [router._load(e) for e in router.engines]
        r = router.submit(rid, prompts[rid], max_new=max_new,
                          deadline_s=None if late is None
                          or rid != late[0] else 600.0)
        records[rid] = router.engines[r].queue[-1]

    first = [rid for rid in range(len(prompts))
             if late is None or rid != late[0]]
    for rid in first:
        submit(rid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step_s = []
    t0 = time.perf_counter()
    while router.busy():
        s0 = time.perf_counter()
        router.step()
        step_s.append(time.perf_counter() - s0)
        if late is not None and late[0] not in records \
                and len(records[late[1]].out) >= late[2]:
            submit(late[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    res = router.results()
    for rid in range(len(prompts)):
        r = res[rid]
        check(r.done and len(r.out) == max_new
              and all(0 <= t < cfg.vocab_size for t in r.out),
              f"[{tag}] request {rid} finished={r.done} with {len(r.out)} "
              f"tokens")
    per = router.stats["replicas"]
    n = cfg.num_layers * sum(p["mixed_steps"] for p in per)
    want = {"paged_attention": n, "fused_mlp": n, "flash_attention": 0,
            "ssd_scan": 0}
    check(counts == want, f"[{tag}] launches {counts} != {want}")
    homes = [router.replica_of(rid) for rid in range(len(prompts))]
    owner, gave_way = {}, 0
    for rid in sorted(loads, key=lambda i: (i == (late or (None,))[0], i)):
        key = router._affinity_key(np.asarray(prompts[rid]))
        if key is None:
            continue
        if key in owner:
            aff = owner[key]
            if loads[rid][aff] <= min(loads[rid]) + router._local.slots:
                check(homes[rid] == aff,
                      f"[{tag}] request {rid} went to replica {homes[rid]} "
                      f"though replica {aff} holds its first block at load "
                      f"{loads[rid]}")
            gave_way += homes[rid] != aff
        else:
            owner[key] = homes[rid]
    step_ms = np.asarray(step_s) * 1e3
    tokens = sum(len(res[r].out) for r in res)
    return {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "steps": len(step_s),
            "step_p50_ms": float(np.percentile(step_ms, 50)),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "homes": homes, "gave_way": gave_way, "launches": counts,
            "replicas": [{k: p[k] for k in (
                "prefills", "mixed_steps", "decode_traces", "peak_pages",
                "prefix_hit_blocks", "prefix_miss_blocks")} for p in per],
            "streams": [list(res[rid].out) for rid in range(len(prompts))]}


def phase_dp_serve(session, main_run: dict, prefix_run: dict, seed: int):
    """Phase 20: Qwen3-14B (phase 5's ``MAIN_LAYERS``) served by a dp 2
    ``ReplicaRouter`` in this process on phase 10's session: both replicas
    on cuda:0, sharing its one set of weights, each with its own pool of 4
    slots x 1024 tokens (16-token pages, 256-row mixed step). Phase 5's six
    prompts (16 new tokens each), then phase 8's shared-prompt traffic
    with the prefix cache (32 new tokens each; request 7 arrives once
    request 2 has ``REPEAT_AFTER`` tokens). Checks: every request
    finishes; both replicas prefill phase 5's traffic; each replica runs
    within the (chunk, page bucket) pairs; the affinity holds
    (``_drive_router``); the streams equal phase 5's and phase 8's bit for
    bit (a mixed row's bits depend on that row alone). Prints tokens/s,
    step p50, each replica's prefix hits and peak pages and the peak
    memory: one host thread steps two replicas on one card, so this is
    not data parallelism's speed."""
    from repro_torch.serve.paging import pages_for
    from repro_torch.serve.step import page_bucket
    cfg = session.cfg
    note = ("one host thread steps both replicas on one card: not data "
            "parallelism's speed")
    kw = dict(slots=4, max_len=1024, page_size=16, chunk_tokens=256)
    out = {"note": note}
    for name, prompts, max_new, extra, want, late in (
            ("phase 5's traffic",
             [np.asarray(p, np.int32)
              for p in serving_prompts(seed, cfg.vocab_size)[1]], 16, {},
             main_run["streams"], None),
            ("phase 8's traffic, prefix cache",
             prefix_prompts(seed, cfg.vocab_size), 32,
             dict(prefix_cache=True), prefix_run["streams"],
             (7, 2, REPEAT_AFTER))):
        router = session.serve(dp=2, devices=["cuda:0"] * 2, **kw, **extra)
        check(router.engines[0].params["embed"].data_ptr()
              == router.engines[1].params["embed"].data_ptr(),
              "[dp serve] the replicas hold two copies of the weights")
        run = _drive_router(router, prompts, max_new, f"dp serve {name}",
                            late=late)
        buckets = len({page_bucket(pages_for(min(len(p) + max_new - 1,
                                                 1024), 16), cap=64)
                       for p in prompts})
        check(all(r["decode_traces"] <= buckets for r in run["replicas"]),
              f"[dp serve {name}] program shapes {run['replicas']} > "
              f"{buckets} page bucket(s)")
        if not extra:
            check(all(r["prefills"] > 0 for r in run["replicas"]),
                  f"[dp serve {name}] replicas {run['replicas']}: each must "
                  f"prefill")
        same = sum(a == b for g, w in zip(run["streams"], want)
                   for a, b in zip(g, w)) / run["tokens"]
        check(run["streams"] == want,
              f"[dp serve {name}] streams differ from the single engine's "
              f"({same:.3f} of tokens equal)")
        run["kv_bytes"] = router.kv_bytes()
        log(f"[dp serve {name}] Qwen3-14B dp 2 on one card: {run['tokens']} "
            f"tokens in {run['wall_s']:.2f}s = {run['tokens_per_s']:.2f} "
            f"tok/s, {run['steps']} rounds, round p50 "
            f"{run['step_p50_ms']:.1f} ms; replicas {run['homes']} (gave "
            f"way {run['gave_way']}); per replica "
            + "; ".join(f"{i}: prefills {r['prefills']}, programs "
                        f"{r['mixed_steps']}, prefix hits "
                        f"{r['prefix_hit_blocks']}, peak pages "
                        f"{r['peak_pages']}, shapes {r['decode_traces']}"
                        for i, r in enumerate(run["replicas"]))
            + f"; peak memory {run['peak_mem_gb']:.2f} GB; KV "
            f"{run['kv_bytes'] / 1e9:.3f} GB; launches {run['launches']}; "
            f"streams equal the single engine's — {note}")
        out[name] = run
        del router
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _family_tp_rank(rank: int, world: int, arch: str, seed: int,
                    max_new: int):
    """One rank of phase 21 (``olmoe-1b-7b``) or 22 (``whisper-tiny``):
    ``Session.serve(tp=)`` on the settings of phase 13 / 15 (the rank
    drawing only its shards), the mixed step, then the split path on the
    same shards; each run through ``_drive`` (launches counted from 0
    just before), its launches as ``_moe_want`` / ``_audio_want`` say.
    Then, for the MoE, phase 32 (``_moe_tie_rank``) once its engines are
    freed."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    torch.cuda.set_device(0)
    cfg = get_config(arch)
    if cfg.arch_type == "audio":
        _, prompts, frames = whisper_requests(seed, cfg.vocab_size,
                                              cfg.d_model, cfg.encoder_ctx)
        kw = dict(slots=WHISPER_SLOTS, max_len=WHISPER_MAX_LEN,
                  page_size=16)
        shapes = {s[1] for s in whisper_tp2_flash_shapes(seed) if s[6]}
    else:
        _, prompts = serving_prompts(seed, cfg.vocab_size)
        frames = None
        kw = dict(slots=4, max_len=1024, page_size=16)
        shapes = {s[1] for s in olmoe_tp2_flash_shapes(seed)}
    t0 = time.perf_counter()
    session = Session(cfg, device="cuda", seed=seed)
    eng = session.serve(tp=world, chunk_tokens=256, **kw)
    torch.cuda.synchronize()
    out = {"rank": rank, "build_s": time.perf_counter() - t0,
           "weights_gb": sum(v.numel() * v.element_size()
                             for v in _leaves(eng.params)) / 1e9,
           "heads": [eng._rank.heads, eng._rank.kv_heads]}
    if cfg.is_moe:
        out["experts"] = int(eng.params["layers"]["moe"]["w_up"].shape[1])
    params = eng.params
    for name in ("mixed", "split"):
        if name == "split":
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            eng = Session(cfg, device="cuda", params=params).serve(
                tp=world, mixed=False, **kw)
        eng._rank.counts.clear()
        eng._rank.bytes.clear()
        run = _drive(eng, prompts, max_new, f"{arch} tp {name} rank {rank}",
                     mixed=name == "mixed", frames=frames)
        want = _family_want(eng, cfg)
        check(run["launches"] == want, f"[{arch} tp {name}] rank {rank} "
                                       f"launches {run['launches']} != {want}")
        if name == "split":
            check(set(eng._prefill_lens) <= shapes,
                  f"[{arch} tp split] prefill lengths "
                  f"{sorted(eng._prefill_lens)} not all held by phase 3 "
                  f"({sorted(shapes)})")
        run["collectives"] = dict(eng._rank.counts)
        run["collective_bytes"] = dict(eng._rank.bytes)
        out[name] = run
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if cfg.is_moe:                     # phase 32 on the same ranks
        del eng, params, session
        gc.collect()
        torch.cuda.empty_cache()
        out["tie"] = _moe_tie_rank(rank, world, seed)
    return out


def phase_family_tp_serve(arch: str, seed: int, single: dict, max_new: int):
    """Phases 21 and 22: ``arch`` uncut at tp 2 over two rank processes
    sharing the card over gloo (``_family_tp_rank``), on the settings and
    requests of its single-card phase (``single``: phase 13's or 15's
    record). Checks on each rank as ``_drive`` and ``_family_want`` say;
    both ranks' streams equal; the decode state a rank (the pool, and the
    cross blocks of whisper-tiny) half of the single-card phase's. The
    share of tokens equal to the single-card streams is reported, not
    checked: bf16 sums the row-parallel attention partials in another
    order. Two ranks share one card's SMs and gloo stages each
    all-reduce through host memory: not tensor parallelism's speed. For
    the MoE, phase 32's one-device f32 reference runs first and its rank
    runs follow phase 21's on the same ranks (``phase_moe_tie_serve``
    checks them)."""
    moe = arch == "olmoe-1b-7b"
    one = _moe_one_device_f32(seed) if moe else None      # phase 32's
    ranks = yield RankJob(_family_tp_rank, (arch, seed, max_new),
                          FAMILY_TP_TIMEOUT_S
                          + (MOE_TIE_TIMEOUT_S if moe else 0.0),
                          f"{arch} tp serve" + (" and tie serve" if moe
                                                else ""))
    note = ("two ranks share one card's SMs and gloo stages each "
            "all-reduce through host memory: not tensor parallelism's "
            "speed")
    out = {"note": note, "ranks": ranks}
    if moe:
        out["tie_one_device_f32"] = one
    for r in ranks:
        kv = r["mixed"]["per_device_kv_bytes"]
        check(kv * 2 == single["mixed"]["kv_bytes"],
              f"[{arch} tp] rank {r['rank']} KV {kv} B x 2 != the single "
              f"card's {single['mixed']['kv_bytes']} B")
        for name in ("mixed", "split"):
            check(r[name]["streams"] == ranks[0][name]["streams"],
                  f"[{arch} tp {name}] rank {r['rank']} streams differ from "
                  f"rank 0's")
    r0 = ranks[0]
    for name in ("mixed", "split"):
        run = r0[name]
        run["agree_with_single"] = sum(
            a == b for g, w in zip(run["streams"], single[name]["streams"])
            for a, b in zip(g, w)) / run["tokens"]
        log(_run_text(f"{arch} tp 2 {name}, rank 0", run)
            + f"; {r0['heads'][0]}/{r0['heads'][1]} heads a rank"
            + (f", {r0['experts']} experts a layer" if "experts" in r0
               else "")
            + f", {r0['weights_gb']:.3f} GB of weights a rank (built in "
            f"{r0['build_s']:.1f}s); KV {run['per_device_kv_bytes']} B a "
            f"rank; peak memory a rank "
            f"{[round(x['peak_mem_gb'], 2) for x in ranks]} GB; collectives "
            f"a rank {run['collectives']}; {run['agree_with_single']:.1%} of "
            f"tokens equal to the single card's streams (information) — "
            f"{note}")
        out[name] = run
    return out


# ------------------------- phases 3, 27: the SSM family and the hybrid at tp

#: phase 27: Mamba2-780M and Zamba2-1.2B at tp 2, a rank's H / 2 whole SSD
#: heads — (1, S, 24, 64, 128) and (1, S, 32, 64, 64) at each of phase 7's
#: and 11's prompt lengths (exact: an SSM prefill is not bucketed); Zamba2's
#: shared block at 16/16 heads x 64 and d_ff 4096 (of 8192), its MLP at
#: each prompt length and at the 4 slots of a decode step; 16 new tokens
#: in bf16 (32 until phases 32-33 joined: the script's time limit), 8 in
#: the f32 check
SSM_TP_SSD = {"mamba2-780m": tuple((1, n, 24, 64, 128) for n in SSM_PROMPTS),
              "zamba2-1.2b": tuple((1, n, 32, 64, 64) for n in SSM_PROMPTS)}
ZAMBA_TP_FLASH = tuple((1, n, n, 16, 16, 64) for n in SSM_PROMPTS)
ZAMBA_TP_MLP = (2048, 4096, (4,) + SSM_PROMPTS)
SSM_TP_NEW, SSM_TP_F32_NEW = 16, 8
SSM_TP_TIMEOUT_S = 480.0
#: the seconds phase 30 adds to phase 27's rank processes
VLM_TP_TIMEOUT_S = 360.0


def phase_ssm_tp_kernels(seed: int):
    """The SSD scan at both families' tp 2 rank shapes (``SSM_TP_SSD``,
    ``_ssd_shape``), flash at Zamba2's (``ZAMBA_TP_FLASH``) and the fused
    MLP at its d 2048 / f 4096 for each row count of ``ZAMBA_TP_MLP``
    (weights at the uncut 38 layers' init scale), each in bf16 per value
    against its plain version with its defect rejected, timed beside its
    library call (SDPA, three matmuls; none for the SSD scan) with its
    bound. Returns {kernel name: {"mamba2_tp2" | "zamba2_tp2": records}}."""
    rng = np.random.default_rng(seed + 2730)
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    ssd = {arch.split("-")[0] + "_tp2": [_ssd_shape(gen, shape,
                                                    f"{arch} tp 2's")
                                         for shape in shapes]
           for arch, shapes in SSM_TP_SSD.items()}
    flash = [_flash_shape(gen, shape, 1e-5, 8e-3, timed=True)
             for shape in ZAMBA_TP_FLASH]
    d, f, rows_list = ZAMBA_TP_MLP
    bf = torch.bfloat16
    wg = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wu = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wd = (torch.randn((f, d), generator=gen, device="cuda")
          * (0.02 / math.sqrt(2 * 38))).to(bf)
    mlp = [_mlp_rows(gen, rows, wg, wu, wd, 1e-3, 8e-3, timed=True)
           for rows in rows_list]
    del wg, wu, wd
    torch.cuda.empty_cache()
    return {"ssd_scan": ssd, "flash_attention": {"zamba2_tp2": flash},
            "fused_mlp": {"zamba2_tp2": mlp}}


def _state_bytes(eng) -> int:
    """Bytes of an engine's SSM states (every ``state`` leaf)."""
    from repro_torch.tree import flatten
    return sum(v.numel() * v.element_size()
               for k, v in flatten(eng._cache).items()
               if k.endswith("/state"))


def _ssm_family_want(cfg):
    return _hybrid_want if cfg.arch_type == "hybrid" else _ssm_want


def _ssm_tp_rank(rank: int, world: int, seed: int):
    """One rank of phase 27: each of Mamba2-780M and Zamba2-1.2B uncut
    through ``Session.serve(tp=)`` (the rank drawing only its shards from
    ``seed``) on phase 7's / 11's six prompts, in bf16 (16 new tokens)
    and in f32 (8), each run through ``_drive`` (launches counted from 0
    just before, as ``_ssm_want`` / ``_hybrid_want`` say), its
    collectives and their bytes by label; then phase 30 on the same rank
    process (``_vlm_tp_rank``)."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    _tp_rank_setup()
    out = {"rank": rank}
    for arch in SSM_TP_SSD:
        rec = {}
        for dtype, new in (("bfloat16", SSM_TP_NEW),
                           ("float32", SSM_TP_F32_NEW)):
            cfg = family_config(arch).with_(dtype=dtype)
            prompts = ssm_requests(np.random.default_rng(seed),
                                   cfg.vocab_size)
            t0 = time.perf_counter()
            session = Session(cfg, device="cuda", seed=seed)
            eng = session.serve(tp=world, slots=4, max_len=2048)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            eng._rank.counts.clear()
            eng._rank.bytes.clear()
            run = _drive(eng, prompts, new, f"{arch} tp {dtype} rank {rank}",
                         mixed=False)
            want = _ssm_family_want(cfg)(cfg, run["prefills"],
                                         run["decode_steps"])
            check(run["launches"] == want,
                  f"[{arch} tp {dtype}] rank {rank} launches "
                  f"{run['launches']} != {want}")
            check(set(eng._prefill_lens) == set(SSM_PROMPTS),
                  f"[{arch} tp {dtype}] prefill lengths "
                  f"{sorted(eng._prefill_lens)} != phase 3's {SSM_PROMPTS}")
            run.update(build_s=build_s, heads=eng._rank.heads,
                       ssm_heads=eng.params[
                           "layers" if cfg.arch_type == "ssm" else "groups"]
                       ["mamba"]["A_log"].shape[-1],
                       weights_gb=sum(v.numel() * v.element_size() for v in
                                      _leaves(eng.params)) / 1e9,
                       state_bytes=_state_bytes(eng),
                       collectives=dict(eng._rank.counts),
                       collective_bytes=dict(eng._rank.bytes))
            rec[dtype] = run
            del eng, session
            gc.collect()
            torch.cuda.empty_cache()
        out[arch] = rec
    out["vlm"] = _vlm_tp_rank(rank, world, seed)     # phase 30, same ranks
    return out


def phase_ssm_tp_serve(seed: int, singles: dict, smi: str):
    """Phase 27: TENSOR-PARALLEL SERVING OF THE SSM FAMILY AND THE HYBRID —
    Mamba2-780M and Zamba2-1.2B at ``FAMILY_LAYERS`` at tp 2 over two
    rank processes sharing the card over gloo (``_ssm_tp_rank``), each
    rank a Mamba2 block of H / 2 whole heads, on phase 7's and 11's
    settings and requests (``singles``: their records). The f32 check
    first: each model in f32 on one device (this process, TF32 off) for 8
    new tokens, then the ranks' f32 run, whose streams must equal it.
    Checks on each rank as ``_drive`` and the families' launch counts
    say; both ranks' streams equal; one ``ssm_out`` and one ``ssm_norm``
    sum a Mamba layer a program (Zamba2: one ``attn_out`` and one
    ``mlp_out`` an application of the shared block) and the embedding,
    logits and sampled-token sums, nothing else; a rank's SSM states half
    of the one-device engine's; ``kv_bytes`` the one-device engine's of
    the same dtype (phase 7's / 11's in bf16). The
    share of bf16 tokens equal to phase 7's / 11's streams is reported:
    bf16 sums the row-parallel partials in another order. Two ranks share
    one card's SMs and gloo stages each all-reduce through host memory:
    not tensor parallelism's speed. Phase 30's f32 reference
    (``_vlm_one_device_f32``) runs and is freed before the ranks start,
    and phase 30 runs on the same rank processes after phase 27: its
    records stay in ``out["ranks"]`` (``"vlm"``) and its reference in
    ``out["vlm_one_device_f32"]`` for ``phase_vlm_tp_serve``."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one = {}
    for arch in SSM_TP_SSD:
        cfg = family_config(arch).with_(dtype="float32")
        eng = Session(cfg, device="cuda", seed=seed).serve(slots=4,
                                                           max_len=2048)
        run = _drive(eng, ssm_requests(np.random.default_rng(seed),
                                       cfg.vocab_size), SSM_TP_F32_NEW,
                     f"{arch} f32 one device", mixed=False)
        one[arch] = {"streams": run["streams"], "kv_bytes": eng.kv_bytes(),
                     "state_bytes": _state_bytes(eng),
                     "tokens_per_s": run["tokens_per_s"]}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    vlm_one = _vlm_one_device_f32(seed)        # phase 30's f32 reference
    ranks = yield RankJob(_ssm_tp_rank, (seed,),
                          SSM_TP_TIMEOUT_S + VLM_TP_TIMEOUT_S,
                          "SSM, hybrid and VLM tp serve")
    note = ("two ranks share one card's SMs and gloo stages each "
            "all-reduce through host memory: not tensor parallelism's "
            "speed")
    out = {"note": note, "card": smi, "ranks": ranks, "one_device_f32": one,
           "vlm_one_device_f32": vlm_one}
    for arch in SSM_TP_SSD:
        cfg = family_config(arch)
        g = cfg.num_layers // cfg.hybrid_attn_every \
            if cfg.arch_type == "hybrid" else 0
        for r in ranks:
            for dtype in ("bfloat16", "float32"):
                run = r[arch][dtype]
                tag = f"[{arch} tp {dtype}] rank {r['rank']}"
                check(run["streams"] == ranks[0][arch][dtype]["streams"],
                      f"{tag} streams differ from rank 0's")
                programs = run["prefills"] + run["decode_steps"]
                c = run["collectives"]
                want = {"ssm_out": cfg.num_layers * programs,
                        "ssm_norm": cfg.num_layers * programs,
                        "embed": programs, "logits": programs,
                        "tokens": programs}
                if g:
                    want.update(attn_out=g * programs, mlp_out=g * programs)
                check({k: c.get(k, 0) for k in want} == want and set(c)
                      <= set(want) | {"clock", "step_check"},
                      f"{tag} collectives {c} != {want} (and the clock "
                      f"and step checks)")
                check(run["state_bytes"] * 2 == one[arch]["state_bytes"],
                      f"{tag} SSM states {run['state_bytes']} B x 2 != the "
                      f"one-device engine's {one[arch]['state_bytes']} B")
                full = one[arch]["kv_bytes"] if dtype == "float32" \
                    else singles[arch]["decode_state_bytes"]
                check(run["kv_bytes"] == full,
                      f"{tag} kv_bytes {run['kv_bytes']} != the one-device "
                      f"engine's {full}")
                check(run["ssm_heads"] * 2 == cfg.ssm_heads,
                      f"{tag} {run['ssm_heads']} SSD heads a rank")
            f32 = r[arch]["float32"]["streams"]
            check(f32 == one[arch]["streams"],
                  f"[{arch} tp f32] rank {r['rank']} streams {f32} != the "
                  f"one-device f32 engine's {one[arch]['streams']}")
        run = ranks[0][arch]["bfloat16"]
        run["agree_with_single"] = sum(
            a == b for got, want in zip(run["streams"],
                                        singles[arch]["streams"])
            for a, b in zip(got, want)) / run["tokens"]
        programs = run["prefills"] + run["decode_steps"]
        per_program = {k: v / programs for k, v in run["collectives"].items()}
        mb = {k: round(v / 1e6, 2) for k, v in
              run["collective_bytes"].items()}
        log(_run_text(f"{arch} tp 2 bf16, rank 0", run)
            + f"; {run['ssm_heads']} of {cfg.ssm_heads} SSD heads a rank"
            + (f", {run['heads']} of {cfg.num_heads} attention heads"
               if g else "")
            + f", {run['weights_gb']:.3f} GB of weights a rank (built in "
            f"{run['build_s']:.1f}s); decode state {run['per_device_kv_bytes']}"
            f" B a rank of {run['kv_bytes']} B (SSM states "
            f"{run['state_bytes']} B = half); peak memory a rank "
            f"{[round(x[arch]['bfloat16']['peak_mem_gb'], 2) for x in ranks]}"
            f" GB; collectives a program {per_program} (MB in all {mb}); "
            f"{run['agree_with_single']:.1%} of tokens equal to the single "
            f"card's bf16 streams (information) — {note}")
        log(f"[{arch} tp 2 f32] both ranks' streams equal the one-device "
            f"f32 engine's over {len(SSM_PROMPTS)} requests x "
            f"{SSM_TP_F32_NEW} tokens (one device "
            f"{one[arch]['tokens_per_s']:.1f} tok/s, tp 2 "
            f"{ranks[0][arch]['float32']['tokens_per_s']:.1f} tok/s) on "
            f"{smi}")
        out[arch] = {"bfloat16": run,
                     "float32": ranks[0][arch]["float32"]}
    return out


# ---------------------------------- phases 3, 4, 23: context-parallel decode

#: phase 23: Qwen3-14B at full width, depth cut to ``CP_LAYERS`` (5 of
#: 40: the script's time limit; 20 from phases 30-31, 10 from phases
#: 32-33), at tp 2 with
#: ``cp_decode``: an 8,192-token prompt and 32 new tokens (8,224 cache
#: positions: 4,112 a rank); its f32 check at 2 layers, full width: a
#: 1,024-token prompt and 8 decode steps
CP_LAYERS, CP_PROMPT, CP_NEW = 5, 8192, 32
CP_F32_LAYERS, CP_F32_PROMPT, CP_F32_STEPS = 2, 1024, 8
#: the f32 check's bound on |CP - head-sharded| logits, as a share of the
#: head-sharded logits' largest magnitude: the two differ only in the
#: order of the fp32 attention sums (per-slice partials combined vs one
#: softmax over every key; the head assembly adds zeros), ~1e-7 relative a
#: sum, so ~1e-6 of the scale is expected; 1e-4 leaves 100x
CP_F32_REL = 1e-4
#: the seconds phase 23's two rank processes may take
CP_TIMEOUT_S = 600.0
#: phase 23's rank shapes at tp 2 (20/4 heads x 128, d 5120, f 8704 a
#: rank): flash over the prompt; the fused MLP over the prompt's rows and
#: the decode step's one row; the f32 check's prompt and row
CP_HEADS, CP_D, CP_F = TP_SHAPES[2]
CP_FLASH = (1, CP_PROMPT, CP_PROMPT) + CP_HEADS + (128,)
CP_MLP_ROWS = (CP_PROMPT, 1)
CP_F32_FLASH = (1, CP_F32_PROMPT, CP_F32_PROMPT) + CP_HEADS + (128,)
CP_F32_MLP_ROWS = (CP_F32_PROMPT, 1)


def _tp2_mlp_weights(gen, dtype):
    """A tp 2 rank's MLP blocks of Qwen3-14B at its init scales (``wo`` /
    ``w_down`` at 0.02 / sqrt(80)), as ``phase_tp_kernels`` draws them."""
    wg, wu = ((torch.randn((CP_D, CP_F), generator=gen, device="cuda")
               * 0.02).to(dtype) for _ in range(2))
    wd = (torch.randn((CP_F, CP_D), generator=gen, device="cuda")
          * (0.02 / math.sqrt(80))).to(dtype)
    return wg, wu, wd


def phase_cp_kernels(seed: int):
    """Flash and the fused MLP at the shapes phase 23 gives them that no
    earlier check holds: bf16 flash at ``CP_FLASH`` (causal) and the MLP
    at d 5120, f 8704 for T 8192 and T 1, per value at phase 3's limits
    (flash atol 1e-5 + rtol 8e-3, the MLP atol 1e-3 + rtol 8e-3), each
    shown to reject its defect and timed beside SDPA / three matmuls with
    its bound; the f32 check's shapes in fp32 (TF32 off): flash at
    ``CP_F32_FLASH`` within phase 3's fp32 2e-6 and the MLP at T 1024 and
    T 1 within its fp32 1e-5 (max abs), each shown to reject its defect
    (dropped keys; a dropped 64-wide f tile). Inputs come from a
    generator of their own. Returns {kernel name: records}."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_mlp as fm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed + 2326)
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    out = {"flash_attention": [_flash_shape(gen, CP_FLASH, 1e-5, 8e-3,
                                            timed=True)]}
    torch.cuda.empty_cache()
    w = _tp2_mlp_weights(gen, torch.bfloat16)
    out["fused_mlp"] = [_mlp_rows(gen, t, *w, 1e-3, 8e-3, timed=True)
                        for t in CP_MLP_ROWS]
    del w
    # fp32 at the f32 check's shapes
    q, k, v = _flash_inputs(gen, CP_F32_FLASH, torch.float32)
    n = CP_F32_FLASH[1]
    want = fa.flash_attention_plain(q, k, v, causal=True)
    err = (fa.flash_attention(q, k, v, causal=True) - want).abs().max().item()
    bad = (fa.flash_attention_plain(q, k, v, causal=True, window=n - 64)
           - want).abs().max().item()
    check(err <= 2e-6, f"flash fp32 at {CP_F32_FLASH}: max abs err {err} "
                       "> 2e-6")
    check(bad > 2e-6, f"the fp32 flash check at {CP_F32_FLASH} passes a "
                      f"version that drops keys ({bad})")
    log(f"[flash f32 {CP_F32_FLASH} causal] max_abs_err {err:.3e} (atol "
        f"2e-6); a version that drops keys would be {bad:.3e}")
    out["flash_attention"].append({"shape": list(CP_F32_FLASH),
                                   "dtype": "float32", "max_abs_err": err,
                                   "dropped_keys_max_abs_err": bad})
    del q, k, v, want
    wg, wu, wd = _tp2_mlp_weights(gen, torch.float32)
    for t in CP_F32_MLP_ROWS:
        x = torch.randn((t, CP_D), generator=gen, device="cuda")
        want = fm.fused_mlp_plain(x, wg, wu, wd)
        err = (fm.fused_mlp(x, wg, wu, wd) - want).abs().max().item()
        wd_drop = wd.clone()
        wd_drop[CP_F // 2:CP_F // 2 + 64] = 0
        bad = (fm.fused_mlp_plain(x, wg, wu, wd_drop) - want).abs().max() \
            .item()
        check(err <= 1e-5, f"fused MLP fp32 at T={t} d={CP_D} f={CP_F}: "
                           f"max abs err {err} > 1e-5")
        check(bad > 1e-5, f"the fp32 MLP check at T={t} passes a dropped f "
                          f"tile ({bad})")
        log(f"[mlp f32 T={t} d={CP_D} f={CP_F}] max_abs_err {err:.3e} (atol "
            f"1e-5); a dropped 64-wide f tile would be {bad:.3e}")
        out["fused_mlp"].append({"t": t, "d": CP_D, "f": CP_F,
                                 "dtype": "float32", "max_abs_err": err,
                                 "dropped_tile_max_abs_err": bad})
    del wg, wu, wd
    torch.cuda.empty_cache()
    return out


#: phase 4's CP runs: tests/test_cp_attention.py's Qwen3 smoke config in
#: f32 with ``cp_decode`` at tp 2, B 4 in a 32-position cache (16 a rank),
#: after a prompt of 28 (the reference test's: every decode position on
#: rank 1) and of 14 (rank 1's slice all masked for two steps, then the
#: cursor on its first position); the reference test's tolerance
CP_PARITY_PROMPTS, CP_PARITY_S, CP_PARITY_TOL = (28, 14), 32, 5e-4
#: phase 4's tp run on one KV head: each rank its sequence slice of the
#: dense rows
CP_PARITY_KV1 = dict(TP_PARITY_CFG, name="pal-dense-kv1", num_kv_heads=1)


def _cp_smoke_cfg():
    from repro_torch.configs import get_smoke
    return get_smoke("qwen3-14b").with_(dtype="float32", cp_decode=True)


def _drop_partial(rank: int):
    """A defective ``cp_attention.combine``: rank ``rank``'s (l, o)
    partial dropped before the sum (its m still in the max)."""
    from repro_torch.core import tp
    from repro_torch.models import cp_attention
    good = cp_attention.combine

    def combine(m, l, o):
        if tp.current().rank == rank:
            l, o = torch.zeros_like(l), torch.zeros_like(o)
        return good(m, l, o)
    return good, combine


def _cp_logits(params, cfg, tokens, prompt: int, total: int):
    """Prefill ``prompt`` tokens of ``tokens`` (B, S) into a cache of
    ``total`` positions (the rank's rows under a current rank), then one
    decode step a remaining token, teacher-forced. Returns (the decode
    steps' logits (steps, B, V) in fp32, the cache)."""
    from repro_torch.models import transformer
    cache = transformer.init_cache(cfg, tokens.shape[0], total,
                                   device=tokens.device)
    transformer.prefill(params, {"tokens": tokens[:, :prompt]}, cfg, cache)
    out = []
    for pos in range(prompt, tokens.shape[1]):
        lg, cache = transformer.decode_step(params, cache,
                                            tokens[:, pos:pos + 1], pos, cfg)
        out.append(lg[:, 0].float())
    return torch.stack(out), cache


def _cp_parity_rank(rank: int, world: int, flat, toks, flat_kv1, prompts):
    """One rank of phase 4's CP runs on cuda:0 (gloo): (a) the Qwen3 smoke
    config's CP decode after each of ``CP_PARITY_PROMPTS``, then the same
    with rank 0's (l, o) partial dropped; (b) the Hkv-1 config on dense
    rows through the engine (the split path), launches counted from 0
    just before."""
    from repro_torch import kernels
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import tp
    from repro_torch.core.strategy import Strategy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import cp_attention
    from repro_torch.params import from_numpy
    from repro_torch.serve.engine import ServeEngine
    _tp_rank_setup()
    cfg = _cp_smoke_cfg()
    mesh = make_mesh((1, world), ("data", "model"))
    params = from_numpy(flat, cfg, "cuda",
                        shard=(Strategy(dtype=cfg.dtype), mesh))
    view = tp.Rank.of(mesh, cfg)
    tokens = torch.from_numpy(toks).cuda()
    out = {"cp": {}}
    good, bad = _drop_partial(0)
    for p in CP_PARITY_PROMPTS:
        with tp.active(view):
            view.counts.clear()
            got, cache = _cp_logits(params, cfg, tokens, p, CP_PARITY_S)
            counts = dict(view.counts)
            cp_attention.combine = bad
            try:
                dropped, _ = _cp_logits(params, cfg, tokens, p, CP_PARITY_S)
            finally:
                cp_attention.combine = good
        sl = cache["kv_slice"]
        out["cp"][p] = {"logits": got.cpu().numpy(),
                        "dropped": dropped.cpu().numpy(),
                        "slice": [sl.start, sl.length, sl.total],
                        "heads": cache["kv"]["k"].shape[3],
                        "collectives": counts}
    kcfg = ModelConfig(**CP_PARITY_KV1)
    eng = ServeEngine(kcfg, from_numpy(flat_kv1, kcfg, "cuda"), slots=2,
                      max_len=64, mesh=mesh, paged=False, mixed=False)
    for i, p in enumerate(prompts):
        eng.submit(i, p, max_new=6)
    kernels.reset_launches()
    res = eng.run()
    out["kv1"] = {"streams": {i: list(res[i].out) for i in res},
                  "launches": kernels.launches(),
                  "want": _want_launches(eng, kcfg.num_layers),
                  "per_device": eng.per_device_kv_bytes(),
                  "kv_bytes": eng.kv_bytes(),
                  "slice": [eng._cache["kv_slice"].start,
                            eng._cache["kv_slice"].length],
                  "decode_steps": eng.stats["decode_steps"],
                  "collectives": dict(eng._rank.counts)}
    return out


def phase_parity_cp():
    """Phase 4's context-parallel runs on two gloo ranks sharing the card
    (TF32 off): (a) the Qwen3 smoke config with ``cp_decode`` at tp 2 (B
    4, 16 of 32 positions a rank) after a prompt of 28 and of 14, four CP
    decode steps each: logits within the reference's 5e-4 of the
    unsharded decode on the card, and a version that drops rank 0's (l,
    o) partial fails that check; (b) the Hkv-1 dense config on dense rows
    (``paged=False``: each rank its sequence slice of every row): streams
    equal to the unsharded engine's on the card, the KV a rank half,
    every kernel launched as ``_want_launches`` says, one head-assembly
    sum, one MAX and one SUM a layer a decode step."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _cp_smoke_cfg()
    params = init_params(cfg, device="cuda", seed=4)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(4, CP_PARITY_S)).astype(np.int32)
    want = {p: _cp_logits(params, cfg, torch.from_numpy(toks).cuda(), p,
                          CP_PARITY_S)[0].cpu().numpy()
            for p in CP_PARITY_PROMPTS}
    kcfg = ModelConfig(**CP_PARITY_KV1)
    kparams = init_params(kcfg, device="cuda", seed=3)
    prompts, _ = _family_requests(kcfg)
    eng = ServeEngine(kcfg, kparams, slots=2, max_len=64, paged=False,
                      mixed=False)
    want_kv1, _ = _serve_run(eng, prompts, None)
    want_kv = eng.per_device_kv_bytes()

    def numpy_tree(p):
        return {k: v.cpu().numpy() for k, v in flatten(p).items()}

    ranks = yield RankJob(_cp_parity_rank, (numpy_tree(params), toks,
                                            numpy_tree(kparams), prompts),
                          240.0, "parity cp tp 2")
    out = {"cp": {}}
    for p in CP_PARITY_PROMPTS:
        errs, drops = [], []
        for r, got in enumerate(ranks):
            run = got["cp"][p]
            err = float(np.abs(run["logits"] - want[p]).max())
            drop = float(np.abs(run["dropped"] - want[p]).max())
            tag = f"[parity cp, prompt {p}] rank {r}"
            check(err <= CP_PARITY_TOL, f"{tag}: logits {err} from the "
                  f"unsharded decode's > {CP_PARITY_TOL}")
            check(drop > CP_PARITY_TOL, f"{tag}: a version that drops rank "
                  f"0's (l, o) partial passes the check ({drop})")
            n = CP_PARITY_S // 2
            check(run["slice"] == [r * n, n, CP_PARITY_S]
                  and run["heads"] == cfg.num_kv_heads,
                  f"{tag}: cache slice {run['slice']}, {run['heads']} heads")
            layers, steps = cfg.num_layers, CP_PARITY_S - p
            check(all(run["collectives"].get(k) == layers * steps
                      for k in ("cp_qkv", "cp_max", "cp_sum")),
                  f"{tag}: collectives {run['collectives']}")
            errs.append(err)
            drops.append(drop)
        log(f"[parity cp tp 2, f32] Qwen3 smoke, prompt {p}, 4 CP decode "
            f"steps, 16 of 32 positions a rank: logits max abs err vs the "
            f"unsharded decode on the card {max(errs):.3e} (<= "
            f"{CP_PARITY_TOL}); rank 0's partial dropped: {min(drops):.3e}")
        out["cp"][p] = {"max_abs_err": max(errs),
                        "dropped_partial_err": min(drops)}
    for r, got in enumerate(ranks):
        run = got["kv1"]
        tag = f"[parity cp kv1 dense rows] rank {r}"
        check(run["streams"] == want_kv1, f"{tag} streams {run['streams']} "
                                          f"!= the unsharded engine's")
        check(run["launches"] == run["want"], f"{tag} launches "
                                              f"{run['launches']}")
        check(run["per_device"] * 2 == want_kv == run["kv_bytes"],
              f"{tag} KV {run['per_device']} B a rank, global "
              f"{run['kv_bytes']}; unsharded {want_kv}")
        check(run["slice"] == [r * 32, 32], f"{tag} slice {run['slice']}")
        coll, steps = run["collectives"], run["decode_steps"]
        check(all(coll.get(k) == kcfg.num_layers * steps
                  for k in ("cp_qkv", "cp_max", "cp_sum")),
              f"{tag} collectives {coll}")
    run = ranks[0]["kv1"]
    log(f"[parity cp tp 2, f32] Hkv-1 dense rows: both ranks' streams equal "
        f"the unsharded engine's over {len(prompts)} requests; KV "
        f"{run['per_device']} B a rank = half of {want_kv} B (positions "
        f"{run['slice']}); launches a rank {run['launches']}; collectives a "
        f"rank {run['collectives']}")
    out["kv1"] = {k: run[k] for k in ("per_device", "kv_bytes", "launches",
                                      "collectives")}
    return out


class _Timed:
    """Times ``transformer.prefill`` and each ``transformer.decode_step``
    (synchronised before and after) while active, and snapshots the
    rank's collectives and bytes of each decode step; keeps the cache the
    prefill filled."""

    def __init__(self, view):
        self.view = view
        self.prefill_s, self.step_s, self.steps, self.cache = 0.0, [], [], None

    def __enter__(self):
        from repro_torch.models import transformer
        self.mod = transformer
        self.orig = (transformer.prefill, transformer.decode_step)
        prefill, decode = self.orig

        def timed_prefill(params, batch, cfg, cache, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = prefill(params, batch, cfg, cache, **kw)
            torch.cuda.synchronize()
            self.prefill_s, self.cache = time.perf_counter() - t0, cache
            return out

        def timed_decode(params, cache, token, pos, cfg):
            counts, nbytes = Counter(self.view.counts), \
                Counter(self.view.bytes)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = decode(params, cache, token, pos, cfg)
            torch.cuda.synchronize()
            self.step_s.append(time.perf_counter() - t0)
            self.steps.append((dict(self.view.counts - counts),
                               dict(self.view.bytes - nbytes)))
            return out

        transformer.prefill, transformer.decode_step = timed_prefill, \
            timed_decode
        return self

    def __exit__(self, *exc):
        self.mod.prefill, self.mod.decode_step = self.orig


def _cp_serve_rank(rank: int, world: int, seed: int, prompt, f32_tokens):
    """One rank of phase 23 on cuda:0 (gloo): Qwen3-14B's shards drawn
    from ``seed``; ``greedy_generate`` under the rank with ``cp_decode``
    (every decode step context-parallel), then without (head-sharded) on
    the same shards, each timed and its launches counted from 0 just
    before; then the f32 check at ``CP_F32_LAYERS`` layers: the CP decode,
    the head-sharded one and the CP decode with rank 0's partial dropped,
    teacher-forced on ``f32_tokens``."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import tp
    from repro_torch.core.strategy import Strategy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import cp_attention
    from repro_torch.params import init_params
    from repro_torch.serve.step import greedy_generate
    torch.cuda.set_device(0)
    mesh = make_mesh((1, world), ("data", "model"))
    base = get_config("qwen3-14b").with_(num_layers=CP_LAYERS)
    strategy = Strategy(dtype=base.dtype)
    t0 = time.perf_counter()
    params = init_params(base, device="cuda", seed=seed,
                         shard=(strategy, mesh))
    torch.cuda.synchronize()
    out = {"rank": rank, "build_s": time.perf_counter() - t0,
           "weights_gb": sum(v.numel() * v.element_size()
                             for v in _leaves(params)) / 1e9,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    view = tp.Rank.of(mesh, base)
    tokens = torch.from_numpy(prompt).cuda()[None]
    for name, cp in (("cp", True), ("heads", False)):
        cfg = base.with_(cp_decode=cp)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        view.counts.clear()
        view.bytes.clear()
        with tp.active(view), _Timed(view) as timed:
            t0 = time.perf_counter()
            streams = greedy_generate(params, cfg, strategy,
                                      {"tokens": tokens}, CP_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kv = timed.cache["kv"]
        sl = timed.cache.get("kv_slice")
        step_ms = np.asarray(timed.step_s) * 1e3
        counts, nbytes = timed.steps[-1]
        out[name] = {"streams": streams[0].tolist(), "wall_s": wall,
                     "prefill_s": timed.prefill_s,
                     "decode_steps": len(timed.step_s),
                     "step_p50_ms": float(np.percentile(step_ms, 50)),
                     "step_max_ms": float(step_ms.max()),
                     "step_collectives": counts, "step_bytes": nbytes,
                     "collectives": dict(view.counts),
                     "bytes": dict(view.bytes),
                     "kv_bytes_rank": sum(a.numel() * a.element_size()
                                          for a in kv.values()),
                     "kv_positions": kv["k"].shape[2],
                     "kv_heads": kv["k"].shape[3],
                     "slice": None if sl is None else [sl.start, sl.length],
                     "launches": kernels.launches(),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "finite": bool(all(0 <= t < base.vocab_size
                                        for t in streams[0].tolist()))}
        del timed
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # the f32 check: full width, 2 layers, TF32 off
    _tp_rank_setup()
    c32 = base.with_(num_layers=CP_F32_LAYERS, dtype="float32")
    p32 = init_params(c32, device="cuda", seed=seed + 1,
                      shard=(Strategy(dtype=c32.dtype), mesh))
    view32 = tp.Rank.of(mesh, c32)
    toks = torch.from_numpy(f32_tokens).cuda()[None]
    total = toks.shape[1]
    logits = {}
    good, bad = _drop_partial(0)
    for name, cp, defect in (("cp", True, False), ("heads", False, False),
                             ("cp, rank 0's partial dropped", True, True)):
        cp_attention.combine = bad if defect else good
        try:
            with tp.active(view32):
                logits[name] = _cp_logits(p32, c32.with_(cp_decode=cp),
                                          toks, CP_F32_PROMPT, total)[0]
        finally:
            cp_attention.combine = good
    ref = logits["heads"]
    scale = float(ref.abs().max())
    out["f32"] = {"scale": scale, "bound": CP_F32_REL * scale,
                  "err": float((logits["cp"] - ref).abs().max()),
                  "dropped_err": float(
                      (logits["cp, rank 0's partial dropped"] - ref)
                      .abs().max()),
                  "positions": total, "streams_equal": bool(torch.equal(
                      logits["cp"].argmax(-1), ref.argmax(-1)))}
    return out


def phase_cp_serve(seed: int, smi: str):
    """Phase 23: Qwen3-14B at full width (40/8 heads x 128, d_ff 17408,
    bf16), depth cut to ``CP_LAYERS`` (5 of 40), with ``cp_decode`` at
    tp 2, two rank processes sharing the card over gloo, each drawing only
    its shards (20/4 heads, d_ff 8704, half the vocabulary).
    ``greedy_generate`` on one 8,192-token prompt for 32 new tokens under the rank (8,224 positions:
    4,112 a rank, all 8 K/V heads; every decode step context-parallel),
    then the head-sharded path on the same shards (all 8,224 positions, 4
    heads a rank). Launches counted from 0 just before each and read just
    after: flash ``CP_LAYERS`` (one prefill), the fused MLP ``CP_LAYERS``
    x 32 (the prefill and 31 decode steps), paged attention and the SSD scan never; both ranks'
    streams equal on each path, every token in the vocabulary, the CP
    cache a rank its 4,112 positions. Prints prefill seconds, decode
    step p50, the collectives and bytes of a decode step by label, the KV
    bytes and peak memory a rank and the share of tokens equal between
    the two paths (information: bf16 sums in another order). Then the f32
    check (TF32 off) at 2 layers, full width: after a 1,024-token prompt,
    8 teacher-forced decode steps' logits of the CP path within
    ``CP_F32_REL`` x the head-sharded logits' largest magnitude of the
    head-sharded path's, and a version that drops rank 0's (l, o) partial
    outside it. Two ranks share one card's SMs and gloo stages each
    collective through host memory: not context parallelism's speed."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-14b").with_(num_layers=CP_LAYERS)
    rng = np.random.default_rng(seed + 23)
    prompt = rng.integers(0, cfg.vocab_size, size=(CP_PROMPT,)).astype(
        np.int32)
    f32_tokens = rng.integers(0, cfg.vocab_size, size=(
        CP_F32_PROMPT + CP_F32_STEPS,)).astype(np.int32)
    ranks = yield RankJob(_cp_serve_rank, (seed, prompt, f32_tokens),
                          CP_TIMEOUT_S, "cp serve")
    note = ("two ranks share one card's SMs and gloo stages each "
            "collective through host memory: not context parallelism's "
            "speed")
    layers, total = cfg.num_layers, CP_PROMPT + CP_NEW
    want = {"flash_attention": layers, "fused_mlp": layers * CP_NEW,
            "paged_attention": 0, "ssd_scan": 0}
    for r in ranks:
        tag = f"[cp serve] rank {r['rank']}"
        for name in ("cp", "heads"):
            run = r[name]
            check(run["streams"] == ranks[0][name]["streams"],
                  f"{tag} {name} streams differ from rank 0's")
            check(len(run["streams"]) == CP_NEW and run["finite"],
                  f"{tag} {name}: {len(run['streams'])} tokens")
            check(run["launches"] == want,
                  f"{tag} {name} launches {run['launches']} != {want}")
            check(run["decode_steps"] == CP_NEW - 1,
                  f"{tag} {name}: {run['decode_steps']} decode steps")
        check(r["cp"]["slice"] == [r["rank"] * total // 2, total // 2]
              and r["cp"]["kv_heads"] == cfg.num_kv_heads,
              f"{tag} CP cache {r['cp']['slice']}, {r['cp']['kv_heads']} "
              "heads")
        check(r["heads"]["slice"] is None
              and r["heads"]["kv_positions"] == total
              and r["heads"]["kv_heads"] == cfg.num_kv_heads // 2,
              f"{tag} head-sharded cache {r['heads']['kv_positions']} x "
              f"{r['heads']['kv_heads']}")
        check(all(r["cp"]["step_collectives"].get(k) == layers
                  for k in ("cp_qkv", "cp_max", "cp_sum")),
              f"{tag} CP step collectives {r['cp']['step_collectives']}")
        f = r["f32"]
        check(f["err"] <= f["bound"], f"{tag} f32 CP logits {f['err']} from "
              f"the head-sharded path's > {f['bound']} ({CP_F32_REL} x "
              f"{f['scale']})")
        check(f["dropped_err"] > f["bound"], f"{tag} f32: a version that "
              f"drops rank 0's partial passes ({f['dropped_err']} <= "
              f"{f['bound']})")
    r0 = ranks[0]
    agree = sum(a == b for a, b in zip(r0["cp"]["streams"],
                                       r0["heads"]["streams"])) / CP_NEW
    out = {"note": note, "card": smi, "agree_cp_heads": agree,
           "ranks": ranks}
    for name in ("cp", "heads"):
        run = r0[name]
        log(f"[cp serve {name}] Qwen3-14B tp 2 on {smi} ({r0['weights_gb']:.2f}"
            f" GB of weights a rank, drawn in {r0['build_s']:.1f}s): prompt "
            f"{CP_PROMPT}, {CP_NEW} new tokens; prefill {run['prefill_s']:.2f}"
            f" s, decode step p50 {run['step_p50_ms']:.1f} ms (max "
            f"{run['step_max_ms']:.1f}); a decode step's collectives "
            f"{run['step_collectives']} and bytes {run['step_bytes']}; KV "
            f"{run['kv_bytes_rank'] / 1e9:.4f} GB a rank ({run['kv_positions']}"
            f" positions x {run['kv_heads']} heads); peak memory a rank "
            f"{[round(x[name]['peak_mem_gb'], 2) for x in ranks]} GB; "
            f"launches a rank {run['launches']} — {note}")
    f = r0["f32"]
    log(f"[cp serve] {agree:.1%} of tokens equal between the CP and the "
        f"head-sharded streams (information: bf16 sums in another order); "
        f"f32 check at {CP_F32_LAYERS} layers, full width, prompt "
        f"{CP_F32_PROMPT}, {CP_F32_STEPS} steps: CP vs head-sharded logits "
        f"max abs {f['err']:.3e} <= {f['bound']:.3e} ({CP_F32_REL} x "
        f"{f['scale']:.3f}); rank 0's partial dropped: "
        f"{f['dropped_err']:.3e}; argmax equal {f['streams_equal']}")
    return out

# ----------------------------------------------------------- phase 24

#: phase 24: Qwen3-14B at full width cut to 2 layers, dp 2 x tp 2 over
#: four gloo rank processes on the card, a fresh global batch of 2 x 2048
#: each step (one 2048-token row a data rank), 1 AdamW step of each run
#: (3 until phases 32-33 joined: the script's time limit)
SHARDED_LAYERS, SHARDED_STEPS, SHARDED_SEQ, SHARDED_BATCH = 2, 1, 2048, 2
SHARDED_MESH = (2, 2)
SHARDED_RUNS = {"zero1": {}, "fsdp": dict(fsdp=True),
                "sp": dict(seq_parallel=True)}
#: its f32 check: 1 layer, full width, global batch 2 x 256, lr 1e-3,
#: against the one-device step at the reference test's bounds
SHARDED_F32_LAYERS, SHARDED_F32_SEQ, SHARDED_F32_LR = 1, 256, 1e-3
SHARDED_LOSS_TOL, SHARDED_PARAM_TOL = 1e-4, 5e-4
SHARDED_TIMEOUT_S = 600.0
SSM_SHARDED_TIMEOUT_S = 400.0
#: the rank shapes flash takes there: a tp 2 rank's 20/4 heads x 128 over
#: one data rank's 2048 positions (bf16); the f32 check's 256 positions at
#: a rank's heads and the one-device step's (2, 256) at all 40/8
TRAIN_TP_FLASH = (1, SHARDED_SEQ, SHARDED_SEQ) + TP_SHAPES[2][0] + (128,)
TRAIN_TP_F32_FLASH = ((1, SHARDED_F32_SEQ, SHARDED_F32_SEQ)
                      + TP_SHAPES[2][0] + (128,),
                      (SHARDED_BATCH, SHARDED_F32_SEQ, SHARDED_F32_SEQ, 40,
                       8, 128))


def phase_train_tp_kernels(seed: int):
    """Flash at the shapes phase 24 gives it: bf16 at ``TRAIN_TP_FLASH``
    and fp32 at ``TRAIN_TP_F32_FLASH`` (``_training_flash``)."""
    return _training_flash(seed + 2427, (TRAIN_TP_FLASH,),
                           TRAIN_TP_F32_FLASH)


def _causal_shape(entry):
    """(B, S, T, Hq, Hkv, D) and its causal flag from a shape entry of six
    (causal) or seven (the flag last)."""
    return tuple(entry[:6]), bool(entry[6]) if len(entry) > 6 else True


def _training_flash(seed: int, shapes, f32_shapes):
    """Flash at the shapes a training phase gives it: bf16 at each of
    ``shapes`` (``_causal_shape`` entries) per value at phase 3's limits
    (atol 1e-5 + rtol 8e-3), shown to reject dropped keys (non-causal:
    the last key tile), timed beside SDPA with its bound, and its plain
    backward (softmax recompute) timed at that shape; fp32 at
    ``f32_shapes`` within phase 3's fp32 2e-6, each shown to reject
    dropped keys. Returns {"flash_attention": records}."""
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    out = []
    for entry in shapes:
        shape, causal = _causal_shape(entry)
        rec = _flash_shape(gen, shape, 1e-5, 8e-3, timed=True, causal=causal)
        q, k, v = _flash_inputs(gen, shape, torch.bfloat16)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        rec["backward_ms"] = time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, g, causal=causal), iters=3, warmup=1)
        log(f"[flash bf16 {shape} {'causal' if causal else 'non-causal'}] "
            f"plain backward (softmax recompute) "
            f"{rec['backward_ms']:.4f} ms")
        out.append(rec)
        del q, k, v, g
    for entry in f32_shapes:
        shape, causal = _causal_shape(entry)
        q, k, v = _flash_inputs(gen, shape, torch.float32)
        n, t = shape[1], shape[2]
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        err = (fa.flash_attention(q, k, v, causal=causal) - want).abs() \
            .max().item()
        if causal:
            bad = fa.flash_attention_plain(q, k, v, causal=True,
                                           window=n - min(64, n // 2))
        else:
            keep = t - (t % 128 or 128)
            bad = fa.flash_attention_plain(q, k[:, :keep], v[:, :keep],
                                           causal=False)
        bad = (bad - want).abs().max().item()
        mode = "causal" if causal else "non-causal"
        check(err <= 2e-6, f"flash fp32 at {shape} {mode}: max abs err "
                           f"{err} > 2e-6")
        check(bad > 2e-6, f"the fp32 flash check at {shape} {mode} passes "
                          f"a version that drops keys ({bad})")
        log(f"[flash f32 {shape} {mode}] max_abs_err {err:.3e} (atol "
            f"2e-6); a version that drops keys would be {bad:.3e}")
        out.append({"shape": list(shape), "dtype": "float32",
                    "causal": causal, "max_abs_err": err,
                    "dropped_keys_max_abs_err": bad})
        del q, k, v, want
    torch.cuda.empty_cache()
    return {"flash_attention": out}


def _fingerprint(x: torch.Tensor) -> int:
    """A position-weighted sum of ``x``'s bits (int64, wrapping): two
    tensors that differ in one element differ in it."""
    bits = x.detach().reshape(-1).view(
        {2: torch.int16, 4: torch.int32}[x.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    step = 1 << 24
    for at in range(0, bits.numel(), step):
        part = bits[at:at + step].long()
        w = torch.arange(at, at + part.numel(), device=x.device) % 65521 + 1
        total += (part * w).sum()
    return int(total)


def _chunked_excess(got, want_host, atol: float, rtol: float) -> float:
    """``worst_excess`` of ``got`` (on the card) against ``want_host`` (on
    the host), 2^24 values at a time: a whole embedding's temporaries
    would not fit beside four ranks."""
    a, b = got.reshape(-1), want_host.reshape(-1)
    step = 1 << 24
    return max(worst_excess(a[at:at + step], b[at:at + step].cuda(), atol,
                            rtol) for at in range(0, a.numel(), step))


def _rank_log(rank: int, msg: str, tag: str = "sharded train") -> None:
    """Progress of the first rank process of phases 24-25 (the others
    are silent), so a failed or slow run shows where it stood."""
    if rank == 0:
        print(f"[{tag} rank 0] {msg}", flush=True)


def _sharded_bf16_run(mesh, cfg, name: str, seed: int, *,
                      steps: int = SHARDED_STEPS, batch: int = SHARDED_BATCH,
                      seq: int = SHARDED_SEQ, data=None,
                      runs=SHARDED_RUNS, prepare=None):
    """One of phase 24's runs on this rank (``runs[name]``: its Strategy
    keywords): a Trainer on ``mesh`` drawing only its shards (then
    ``prepare(params)``, where given), ``steps`` steps on the token
    dataset's global batches of ``batch`` x ``seq`` from ``seed`` (or on
    ``data``); launches counted from 0 just before the steps; each step's
    time, metrics and the fingerprints of the data-replicated param
    blocks; the last step's collectives and bytes."""
    from repro_torch import kernels
    from repro_torch.core.strategy import Strategy
    from repro_torch.train.trainer import TrainConfig, Trainer
    from repro_torch.tree import flatten
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    strategy = Strategy(dtype=cfg.dtype, **runs[name])
    t0 = time.perf_counter()
    trainer = Trainer(cfg, strategy, "cuda", TrainConfig(
        steps=steps, lr=3e-4, log_every=1, seed=seed), data=data,
        global_batch=batch, seq_len=seq, mesh=mesh)
    if prepare is not None:
        prepare(trainer.params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    r = trainer.rank
    flat = flatten(trainer.params)
    replicated = [k for k in flat if r.leaves[k].fsdp_dim is None]
    out = {"build_s": build_s, "step_s": [], "fingerprints": [],
           "params_rank": sum(v.numel() for v in flat.values()),
           "param_gb_rank": sum(v.numel() * v.element_size()
                                for v in flat.values()) / 1e9,
           "state_gb_rank": sum(v.numel() * v.element_size()
                                for sub in trainer.opt_state.values()
                                if isinstance(sub, dict)
                                for v in flatten(sub).values()) / 1e9,
           "replicated_leaves": len(replicated)}
    kernels.reset_launches()
    for i in range(steps):
        if i == steps - 1:
            r.counts.clear()
            r.bytes.clear()
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        trainer.run(1)                      # ends in float(loss): a sync
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - s0)
        flat = flatten(trainer.params)
        out["fingerprints"].append({k: _fingerprint(flat[k])
                                    for k in replicated})
    out["launches"] = kernels.launches()
    out["history"] = [{k: h[k] for k in ("loss", "aux_loss", "grad_norm")}
                      for h in trainer.history]
    out["step_collectives"] = dict(r.counts)
    out["step_bytes"] = dict(r.bytes)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del trainer, flat
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextmanager
def _dropped_dp_grads():
    """The defect: the "data" gradient sum left out."""
    from repro_torch.core import tp
    real = tp.axis_sum

    def dropped(x, axis, what, r=None):
        return x if what == "dp_grads" else real(x, axis, what, r)
    tp.axis_sum = dropped
    try:
        yield
    finally:
        tp.axis_sum = real


@contextmanager
def _unsummed_norm_grad():
    """The defect: the gated norm's sum over "model" with the identity
    for its backward (g alone), where each rank's gradient of the total is
    a partial."""
    from repro_torch.core import tp
    real = tp.norm_sum
    tp.norm_sum = tp.all_reduce
    try:
        yield
    finally:
        tp.norm_sum = real


#: phase 24's f32 defects: a run name -> the context that breaks it
SHARDED_DEFECTS = {"zero1, data gradient sum dropped": _dropped_dp_grads}


def _sharded_f32_rank(mesh, seed: int, data, cfg=None, defects=None,
                      ref=None):
    """Phase 24's f32 check on this rank (TF32 off): the one-device step
    (full width, ``SHARDED_F32_LAYERS`` layer of Qwen3-14B, or ``cfg``)
    made before the ranks started where ``ref`` names it ((name, metrics):
    ``_one_device_reference``'s files, each rank reading its blocks by
    memory map); else the first rank runs it alone on the card and
    broadcasts its new params and metrics from the host to every rank's
    host (gloo on CPU tensors). Then every rank runs one step of each of
    ``SHARDED_RUNS`` on ``data``
    (the global batch, a dict of numpy arrays) on its
    shards — and a ZeRO-1 run under each of ``defects`` (default
    ``SHARDED_DEFECTS``: without the "data" gradient sum) — and holds its
    blocks to the same blocks of the one-device step's: the worst |err| /
    (atol + rtol |want|) at the reference test's 5e-4, and the loss's
    distance."""
    from repro_torch.configs import get_config
    from repro_torch.core import tp
    from repro_torch.core.strategy import Strategy, mesh_axes
    from repro_torch.params import full_shapes, init_params
    from repro_torch.train import step as tstep
    from repro_torch.tree import flatten
    if cfg is None:
        cfg = get_config("qwen3-14b").with_(num_layers=SHARDED_F32_LAYERS,
                                            dtype="float32")
    defects = SHARDED_DEFECTS if defects is None else defects
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    shapes = full_shapes(cfg)
    axes, coord = mesh_axes(mesh), tp.coordinate(mesh)
    if ref is not None:
        ref_name, one_device = ref
        out = {"one_device": dict(one_device)}

        def reference(key, spec):
            return _reference_block(ref_name, "param", key, spec, axes,
                                    coord)
    else:
        out = {}
        full = _broadcast_reference(cfg, seed, batch, shapes, out)

        def reference(key, spec):
            return tp.shard_leaf(full[key], spec, axes, coord)
    runs = dict(SHARDED_RUNS)
    runs.update(dict.fromkeys(defects, {}))
    for name, kw in runs.items():
        t0 = time.perf_counter()
        st = Strategy(dtype="float32", **kw)
        rank = tp.Rank.of(mesh, cfg, st, shapes)
        params = init_params(cfg, device="cuda", seed=seed + 1,
                             shard=(st, mesh))
        step = tstep.make_train_step(cfg, st, lr=SHARDED_F32_LR)
        with defects.get(name, nullcontext)(), tp.active(rank):
            opt = tstep.init_opt_state(params, st)
            new, opt, m = step(params, opt, batch)
        worst, worst_key = 0.0, None
        for key, block in flatten(new).items():
            want = reference(key, rank.leaves[key].spec)
            e = _chunked_excess(block.detach(), want, SHARDED_PARAM_TOL,
                                SHARDED_PARAM_TOL)
            if e > worst:
                worst, worst_key = e, key
        out[name] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "param_error_of_limit": worst, "worst_leaf": worst_key,
                     "loss_err": abs(float(m["loss"])
                                     - out["one_device"]["loss"]),
                     "run_s": time.perf_counter() - t0}
        del params, new, opt, step, m
        gc.collect()
        torch.cuda.empty_cache()
    return out


def f32_runs_s(f32: dict) -> str:
    """The seconds of each run of an f32 check (its draw, step and
    comparison), for a rank's progress line."""
    return ", ".join(f"{k} {v['run_s']:.1f}s" for k, v in f32.items()
                     if isinstance(v, dict) and "run_s" in v)


def _broadcast_reference(cfg, seed: int, batch, shapes, out: dict) -> dict:
    """The one-device f32 step of ``_sharded_f32_rank`` run by the first
    rank alone on the card, its new params moved to the host and
    broadcast to every rank's host (gloo on CPU tensors): {key: full
    leaf}; its metrics and the broadcast's seconds go into ``out``."""
    import torch.distributed as dist
    from repro_torch.core.strategy import Strategy
    from repro_torch.params import init_params
    from repro_torch.train import step as tstep
    from repro_torch.tree import flatten
    lead = dist.get_rank() == 0
    ref = {}
    metrics = torch.zeros(2, dtype=torch.float64)
    if lead:
        st = Strategy(dtype="float32")
        params = init_params(cfg, device="cuda", seed=seed + 1)
        step = tstep.make_train_step(cfg, st, lr=SHARDED_F32_LR)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, opt, m = step(params, tstep.init_opt_state(params, st), batch)
        torch.cuda.synchronize()
        out["one_device"] = {"step_s": time.perf_counter() - t0,
                             "peak_mem_gb":
                             torch.cuda.max_memory_allocated() / 1e9}
        metrics[:] = torch.tensor([float(m["loss"]), float(m["grad_norm"])])
        ref = {k: v.detach().cpu() for k, v in flatten(new).items()}
        del params, new, opt, step, m
        gc.collect()
        torch.cuda.empty_cache()
    # the first rank's result to every rank, on the host (gloo, CPU)
    t0 = time.perf_counter()
    dist.broadcast(metrics, src=0)
    for key, shape in shapes.items():
        if not lead:
            ref[key] = torch.empty(shape, dtype=torch.float32)
        dist.broadcast(ref[key], src=0)
    out["broadcast_s"] = time.perf_counter() - t0
    out.setdefault("one_device", {}).update(loss=float(metrics[0]),
                                            grad_norm=float(metrics[1]))
    return ref


def _sharded_train_rank(rank: int, world: int, seed: int, f32_ref,
                        ssm_tokens, whisper_f32, vlm_f32, moe_f32):
    """One rank of phase 24 on cuda:0 (gloo): the three bf16 runs, then
    the f32 check against the one-device step made before the ranks
    started (``f32_ref``: its batch and metrics); then phase 25 (``_pipe_rank``), phase 28
    (``_ssm_sharded_rank``), phase 29 (``_whisper_sharded_rank``), phase
    31 (``_vlm_sharded_rank``) and phase 33 (``_moe_sharded_rank``) on the
    same ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    _tp_rank_setup()
    mesh = make_mesh(SHARDED_MESH, ("data", "model"))
    cfg = get_config("qwen3-14b").with_(num_layers=SHARDED_LAYERS)
    out = {"rank": rank, "coord": {n: int(mesh[n].get_local_rank())
                                   for n in mesh.mesh_dim_names}}
    t0 = time.perf_counter()
    for name in SHARDED_RUNS:
        out[name] = _sharded_bf16_run(mesh, cfg, name, seed)
        _rank_log(rank, f"{name} done at {time.perf_counter() - t0:.1f}s: "
                        f"steps {[round(x, 3) for x in out[name]['step_s']]}"
                        f" s, peak {out[name]['peak_mem_gb']:.2f} GB")
    out["f32"] = _sharded_f32_rank(mesh, seed, f32_ref["batch"],
                                   ref=("qwen", f32_ref["one_device"]))
    _rank_log(rank, f"f32 check done at {time.perf_counter() - t0:.1f}s: "
                    + f32_runs_s(out["f32"]))
    out["pipe"] = _pipe_rank(rank, seed)           # phase 25, same ranks
    out["ssm"] = _ssm_sharded_rank(rank, mesh, seed, ssm_tokens)
    out["whisper"] = _whisper_sharded_rank(rank, mesh, seed, whisper_f32)
    out["vlm"] = _vlm_sharded_rank(rank, mesh, seed, vlm_f32)
    out["moe"] = _moe_sharded_rank(rank, mesh, seed, moe_f32)
    return out


#: phase 28: Mamba2-780M at full width, depth cut to 12 of 48 layers
#: (the script's time limit: 24 until phases 30-31), at dp 2 x tp 2 on
#: phase 24's ranks, its
#: runs, steps, batch and sequence; its f32 check at 2 layers, full width,
#: on phase 24's 2 x 256 tokens
SSM_SHARDED_ARCH, SSM_SHARDED_LAYERS, SSM_SHARDED_F32_LAYERS = \
    "mamba2-780m", 12, 2
#: its f32 defects: phase 24's, and the gated norm's sum with the
#: identity for a backward
SSM_SHARDED_DEFECTS = dict(SHARDED_DEFECTS, **{
    "zero1, ssm_norm gradient not summed": _unsummed_norm_grad})


def _ssm_sharded_rank(rank: int, mesh, seed: int, tokens):
    """One rank of phase 28: phase 24's three bf16 runs and its f32 check
    on Mamba2-780M (``SSM_SHARDED_*``)."""
    from repro_torch.configs import get_config
    cfg = get_config(SSM_SHARDED_ARCH).with_(num_layers=SSM_SHARDED_LAYERS)
    out = {}
    t0 = time.perf_counter()
    for name in SHARDED_RUNS:
        out[name] = _sharded_bf16_run(mesh, cfg, name, seed)
        _rank_log(rank, f"{name} done at {time.perf_counter() - t0:.1f}s: "
                        f"steps {[round(x, 3) for x in out[name]['step_s']]}"
                        f" s, peak {out[name]['peak_mem_gb']:.2f} GB",
                  "ssm sharded train")
    out["f32"] = _sharded_f32_rank(
        mesh, seed, {"tokens": tokens}, cfg.with_(num_layers=SSM_SHARDED_F32_LAYERS,
                                      dtype="float32"), SSM_SHARDED_DEFECTS)
    _rank_log(rank, f"f32 check done at {time.perf_counter() - t0:.1f}s: "
                    + f32_runs_s(out["f32"]), "ssm sharded train")
    return out


def phase_train_sharded(seed: int, smi: str):
    """Phase 24: SHARDED TRAINING of Qwen3-14B at full width (40/8 heads x
    128, d_ff 17408, vocab 151,936; depth cut to ``SHARDED_LAYERS``) at
    dp 2 x tp 2: four rank processes sharing the card over gloo
    (``launch/ranks.py``; NCCL refuses two ranks on one device), each
    drawing only its shards through ``Trainer(mesh=)``. Three runs of
    ``SHARDED_STEPS`` AdamW steps (remat on), each on a fresh global
    batch of 2 x 2048 tokens from the token dataset (``--seed``): ZeRO-1
    (the default), FSDP and sequence parallelism.
    Launches counted from 0 around each run: flash layers x 2 (forward
    and remat recompute) a step a rank, the others never. Every rank
    reports the same loss and grad norm each step; the two data replicas'
    param blocks are equal bit for bit after each step (a fingerprint of
    each data-replicated block); a rank's failure or timeout fails the
    run. Prints step p50, tokens/s, peak memory a rank and a step's
    collectives and bytes by label. Then the f32 check (TF32 off) at
    ``SHARDED_F32_LAYERS`` layer, full width, global batch 2 x 256: the
    one-device step first (in this process before the ranks start, its
    new params written to ``F32_REF_DIR``), then each run at (2, 2): loss
    within 1e-4 and every param block within atol / rtol 5e-4 of the
    one-device step's (the reference test's bounds), and a version that
    drops the "data" gradient sum outside them. Four ranks share one
    card's SMs and gloo stages every collective through host memory:
    these numbers are not parallelism's speed."""
    from repro_torch.configs import get_config
    from repro_torch.core.strategy import Strategy
    cfg = get_config("qwen3-14b")
    rng = np.random.default_rng(seed + 24)
    f32_tokens = rng.integers(0, cfg.vocab_size, size=(
        SHARDED_BATCH, SHARDED_F32_SEQ)).astype(np.int32)
    ssm_tokens = rng.integers(0, get_config(SSM_SHARDED_ARCH).vocab_size,
                              size=(SHARDED_BATCH, SHARDED_F32_SEQ)
                              ).astype(np.int32)
    wcfg = get_config("whisper-tiny")
    whisper_f32 = {
        "tokens": rng.integers(0, wcfg.vocab_size, size=(
            WHISPER_SHARDED_F32_BATCH, WHISPER_TRAIN)).astype(np.int32),
        "frames": rng.standard_normal((WHISPER_SHARDED_F32_BATCH,
                                       wcfg.encoder_ctx, wcfg.d_model),
                                      dtype=np.float32)}
    vcfg = get_config("llama-3.2-vision-90b")
    vlm_f32 = {
        "tokens": rng.integers(0, vcfg.vocab_size, size=(
            VLM_SHARDED_F32_BATCH, VLM_SHARDED_F32_SEQ)).astype(np.int32),
        "image_embeds": rng.standard_normal(
            (VLM_SHARDED_F32_BATCH, vcfg.num_image_tokens, vcfg.d_model),
            dtype=np.float32)}
    moe_batch = {"tokens": rng.integers(
        0, get_config("olmoe-1b-7b").vocab_size,
        size=(SHARDED_BATCH, SHARDED_F32_SEQ)).astype(np.int32)}
    gc.collect()
    torch.cuda.empty_cache()
    # phase 24's and phase 33's one-device f32 steps, made once before the
    # ranks start (each rank reads its blocks of their files)
    qwen_batch = {"tokens": f32_tokens}
    qwen_f32 = {"batch": qwen_batch, "one_device": _one_device_reference(
        "qwen", cfg.with_(num_layers=SHARDED_F32_LAYERS, dtype="float32"),
        Strategy(dtype="float32"), seed, qwen_batch, lambda key: False)}
    moe_f32 = {"batch": moe_batch,
               "one_device": _moe_f32_reference(seed, moe_batch)}
    ranks = yield RankJob(_sharded_train_rank,
                          (seed, qwen_f32, ssm_tokens, whisper_f32,
                           vlm_f32, moe_f32),
                          SHARDED_TIMEOUT_S + PIPE_TIMEOUT_S
                          + SSM_SHARDED_TIMEOUT_S
                          + WHISPER_SHARDED_TIMEOUT_S
                          + VLM_SHARDED_TIMEOUT_S + MOE_SHARDED_TIMEOUT_S,
                          "sharded train, pipeline, SSM, whisper, VLM and "
                          "MoE sharded train", world=math.prod(SHARDED_MESH))
    want = {"flash_attention": SHARDED_LAYERS * 2 * SHARDED_STEPS,
            "fused_mlp": 0, "paged_attention": 0, "ssd_scan": 0}
    out = _sharded_checks(ranks, f"Qwen3-14B {SHARDED_LAYERS} layers",
                          f"Qwen3-14B {SHARDED_F32_LAYERS} layer", want,
                          SHARDED_DEFECTS, smi, "sharded train")
    out["ranks"] = ranks
    return out


def phase_ssm_train_sharded(ranks, smi: str):
    """Phase 28: SHARDED TRAINING OF THE SSM FAMILY, on phase 24's four
    rank processes (``_ssm_sharded_rank``): Mamba2-780M at full width,
    depth cut to ``SSM_SHARDED_LAYERS`` (12 of 48), 24 of 48 SSD heads a
    rank (``in_proj`` and the conv by head with all of B and C), at dp 2
    x tp 2, phase 24's three runs
    (ZeRO-1, FSDP, sequence parallelism) of its steps and batches, and its
    checks (``_sharded_checks``): the SSM family trains through the plain
    SSD scan, so no kernel launches (the kernel has no backward). Then
    the f32 check at 2 layers, full width, with two defects outside its
    bound: the "data" gradient sum dropped, and the gated norm's sum over
    "model" without its backward sum."""
    want = {"flash_attention": 0, "fused_mlp": 0, "paged_attention": 0,
            "ssd_scan": 0}
    runs = [dict(r.pop("ssm"), rank=r["rank"], coord=r["coord"])
            for r in ranks]
    out = _sharded_checks(
        runs, f"Mamba2-780M {SSM_SHARDED_LAYERS} layers",
        f"Mamba2-780M {SSM_SHARDED_F32_LAYERS} layers", want,
        SSM_SHARDED_DEFECTS, smi, "ssm sharded train")
    out["ranks"] = runs
    return out


# ----------------------------------------------------------- phase 29

#: phase 29: whisper-tiny at full width, uncut (4 encoder and 4 decoder
#: layers, 6/6 heads x 64, 1500 frames, vocabulary 51,865), dp 2 x tp 2 on
#: phase 24's four rank processes after phase 28: phase 24's three runs of
#: ``WHISPER_SHARDED_STEPS`` AdamW steps (remat on), each step a global
#: batch of 8 x 448 tokens beside one (8, 1500, 384) frames block
#: (``launch/train.py::FramesData``, from ``--seed``); its f32 check
#: uncut on a global batch of 2 x 448 tokens with (2, 1500, 384) frames;
#: 2 steps (3 until phases 32-33 joined: the script's time limit)
WHISPER_SHARDED_STEPS, WHISPER_SHARDED_BATCH = 2, 8
WHISPER_SHARDED_F32_BATCH = 2
WHISPER_SHARDED_TIMEOUT_S = 300.0
#: the rank shapes flash takes there (B, S, T, Hq, Hkv, D, causal): a tp 2
#: rank's 3/3 heads x 64 over a data rank's 4 rows, the encoder non-causal
#: and the decoder causal (bf16); the f32 check's at a rank (1 row) and
#: in its one-device step (2 rows, 6/6 heads)
WHISPER_TRAIN_TP_FLASH = tuple(
    (WHISPER_SHARDED_BATCH // SHARDED_MESH[0], n, n) + WHISPER_TP2_HEADS
    + (WHISPER_D, causal) for n, causal in ((1500, False),
                                            (WHISPER_TRAIN, True)))
WHISPER_TRAIN_TP_F32_FLASH = tuple(
    (b, n, n) + heads + (WHISPER_D, causal)
    for b, heads in ((1, WHISPER_TP2_HEADS), (2, WHISPER_HEADS))
    for n, causal in ((1500, False), (WHISPER_TRAIN, True)))


def phase_whisper_train_tp_kernels(seed: int):
    """Flash at the shapes phase 29 gives it: bf16 at
    ``WHISPER_TRAIN_TP_FLASH`` (the encoder non-causal, the decoder
    causal) and fp32 at ``WHISPER_TRAIN_TP_F32_FLASH``
    (``_training_flash``)."""
    return _training_flash(seed + 2929, WHISPER_TRAIN_TP_FLASH,
                           WHISPER_TRAIN_TP_F32_FLASH)


@contextmanager
def _dropped_cross_sum():
    """The defect: ``enc_out`` enters each decoder layer's cross K/V
    projection without its backward "model" sum (``cross_in``), so each
    rank's gradient into the encoder is the partial of its own heads."""
    from repro_torch.core import tp
    real = tp.region_in

    def dropped(h, what, *, seq=False):
        return h if what == "cross" else real(h, what, seq=seq)
    tp.region_in = dropped
    try:
        yield
    finally:
        tp.region_in = real


#: phase 29's f32 defects: phase 24's, and the cross K/V's input without
#: its backward sum
WHISPER_SHARDED_DEFECTS = dict(SHARDED_DEFECTS, **{
    "zero1, enc_out gradient not summed": _dropped_cross_sum})


def _whisper_sharded_rank(rank: int, mesh, seed: int, f32_batch):
    """One rank of phase 29: phase 24's three bf16 runs on whisper-tiny
    uncut (``WHISPER_SHARDED_*``, frames from ``FramesData``) and the f32
    check on ``f32_batch`` with ``WHISPER_SHARDED_DEFECTS``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import FramesData
    cfg = get_config("whisper-tiny")
    out = {}
    t0 = time.perf_counter()
    for name in SHARDED_RUNS:
        data = FramesData(cfg, global_batch=WHISPER_SHARDED_BATCH,
                          seq_len=WHISPER_TRAIN, seed=seed)
        out[name] = _sharded_bf16_run(
            mesh, cfg, name, seed, steps=WHISPER_SHARDED_STEPS,
            batch=WHISPER_SHARDED_BATCH, seq=WHISPER_TRAIN, data=data)
        _rank_log(rank, f"{name} done at {time.perf_counter() - t0:.1f}s: "
                        f"steps {[round(x, 3) for x in out[name]['step_s']]}"
                        f" s, peak {out[name]['peak_mem_gb']:.2f} GB",
                  "whisper sharded train")
    out["f32"] = _sharded_f32_rank(mesh, seed, f32_batch,
                                   cfg.with_(dtype="float32"),
                                   WHISPER_SHARDED_DEFECTS)
    _rank_log(rank, f"f32 check done at {time.perf_counter() - t0:.1f}s: "
                    + f32_runs_s(out["f32"]), "whisper sharded train")
    return out


def phase_whisper_train_sharded(ranks, smi: str):
    """Phase 29: SHARDED TRAINING OF THE ENC-DEC FAMILY, on phase 24's
    four rank processes (``_whisper_sharded_rank``): whisper-tiny at full
    width, uncut, 3/3 heads a rank (self and cross), the whole 51,865-row
    ``lm_head`` and ``tok_embed`` on every model rank (the vocabulary does
    not divide tp 2), at dp 2 x tp 2, phase 24's three runs (ZeRO-1, FSDP,
    sequence parallelism: the encoder's 1500 frames and the decoder's 448
    tokens each split over "model") and its checks (``_sharded_checks``):
    flash once an encoder and a decoder layer a step and once more a
    decoder layer for the remat recompute (a data rank's (4, 1500, 1500,
    3, 3, 64) non-causal and (4, 448, 448, 3, 3, 64) causal), the other
    kernels never. Then the f32 check, uncut, with two defects outside its
    bound: the "data" gradient sum dropped, and ``enc_out``'s backward
    "model" sum into the cross K/V dropped (every encoder parameter's
    gradient a rank's partial)."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-tiny")
    want = {"flash_attention": WHISPER_SHARDED_STEPS
            * (cfg.encoder_layers + 2 * cfg.num_layers),
            "fused_mlp": 0, "paged_attention": 0, "ssd_scan": 0}
    runs = [dict(r.pop("whisper"), rank=r["rank"], coord=r["coord"])
            for r in ranks]
    out = _sharded_checks(
        runs, "whisper-tiny uncut", "whisper-tiny uncut", want,
        WHISPER_SHARDED_DEFECTS, smi, "whisper sharded train",
        steps=WHISPER_SHARDED_STEPS, batch=WHISPER_SHARDED_BATCH,
        seq=WHISPER_TRAIN,
        f32_shape=(WHISPER_SHARDED_F32_BATCH, WHISPER_TRAIN))
    out["ranks"] = runs
    return out


def _sharded_checks(ranks, model: str, f32_model: str, want: dict,
                    defects: dict, smi: str, tag: str, *,
                    steps: int = SHARDED_STEPS, batch: int = SHARDED_BATCH,
                    seq: int = SHARDED_SEQ,
                    f32_shape=(SHARDED_BATCH, SHARDED_F32_SEQ),
                    runs_by_name=SHARDED_RUNS, f32_runs=None) -> dict:
    """Phase 24's (and 28's, 29's, 31's) checks over the ranks' records:
    launches as ``want`` on each rank and run of ``runs_by_name``; the
    same metrics on every rank each step, finite; the data replicas'
    param blocks equal bit for bit; then the f32 check's runs within its
    bounds (params; gradients too where a run reports them; the runs of
    ``f32_runs``, default ``runs_by_name``) and each of ``defects``
    outside them. ``steps`` of ``batch`` x ``seq`` tokens a
    run, the f32 check's ``f32_shape``. Logs each run and returns the
    summary."""
    note = ("four ranks share one card's SMs and gloo stages every "
            "collective through host memory: not parallelism's speed")
    out = {"note": note, "card": smi}
    tokens_step = batch * seq
    for name in runs_by_name:
        for r in ranks:
            run, rt = r[name], f"[{tag} {name}] rank {r['rank']}"
            check(run["launches"] == want,
                  f"{rt} launches {run['launches']} != {want}")
            check(run["history"] == ranks[0][name]["history"],
                  f"{rt} metrics {run['history']} differ from rank 0's "
                  f"{ranks[0][name]['history']}")
            check(all(math.isfinite(h["loss"]) and math.isfinite(
                h["grad_norm"]) for h in run["history"]),
                f"{rt} metrics {run['history']}")
            for other in ranks:
                if other["coord"]["model"] == r["coord"]["model"]:
                    check(other[name]["fingerprints"] == run["fingerprints"],
                          f"{rt}: its data replica's param blocks differ")
        r0 = ranks[0][name]
        check("fsdp" in name or r0["replicated_leaves"] > 0,
              f"[{tag} {name}] no data-replicated block to compare")
        p50 = float(np.percentile(r0["step_s"], 50))
        out[name] = {"step_p50_s": p50, "tokens_per_s": tokens_step / p50,
                     "peak_mem_gb_ranks": [x[name]["peak_mem_gb"]
                                           for x in ranks],
                     "losses": [h["loss"] for h in r0["history"]]}
        log(f"[{tag} {name}] {model}, full width, "
            f"dp 2 x tp 2 on {smi}: {r0['params_rank'] / 1e9:.3f} B params "
            f"({r0['param_gb_rank']:.2f} GB) and {r0['state_gb_rank']:.2f} GB "
            f"of optimizer state a rank (drawn in {r0['build_s']:.1f}s); "
            f"{steps} steps of {batch} x {seq} "
            f"tokens: step p50 {p50:.3f} s ({[round(x, 3) for x in r0['step_s']]}"
            f"), {tokens_step / p50:.1f} tokens/s; peak memory a rank "
            f"{[round(x[name]['peak_mem_gb'], 2) for x in ranks]} GB; losses "
            f"{[round(h['loss'], 4) for h in r0['history']]}, grad norms "
            f"{[round(h['grad_norm'], 4) for h in r0['history']]}; a step's "
            f"collectives {r0['step_collectives']} and MB "
            f"{ {k: round(v / 1e6, 1) for k, v in r0['step_bytes'].items()} };"
            f" data replicas equal bit for bit on {r0['replicated_leaves']} "
            f"blocks; launches {r0['launches']} — {note}")
    f = ranks[0]["f32"]
    check(all(r["f32"]["one_device"]["loss"] == f["one_device"]["loss"]
              for r in ranks), f"[{tag} f32] the one-device step's loss "
                               "differs between ranks after its broadcast")
    def worst(rec):
        return max(rec["param_error_of_limit"],
                   rec.get("grad_error_of_limit", 0.0))

    f32_runs = runs_by_name if f32_runs is None else f32_runs
    for r in ranks:             # each rank's own blocks; the worst kept
        for name in list(f32_runs) + list(defects):
            mine = r["f32"][name]
            loss_err = max(f[name]["loss_err"], mine["loss_err"])
            if worst(mine) > worst(f[name]):
                f[name] = dict(mine)
            f[name]["loss_err"] = loss_err
    for name in f32_runs:
        rec = f[name]
        check(rec["loss_err"] <= SHARDED_LOSS_TOL,
              f"[{tag} f32 {name}] loss {rec['loss']} is {rec['loss_err']} "
              f"from the one-device step's")
        check(rec["param_error_of_limit"] <= 1.0,
              f"[{tag} f32 {name}] {rec['worst_leaf']} at "
              f"{rec['param_error_of_limit']:.3f}x atol/rtol 5e-4")
        check(rec.get("grad_error_of_limit", 0.0) <= 1.0,
              f"[{tag} f32 {name}] the gradient of {rec.get('worst_grad_leaf')}"
              f" at {rec.get('grad_error_of_limit', 0.0):.3f}x its bound")
    for name in defects:
        check(worst(f[name]) > 1.0,
              f"[{tag} f32] the check passes the defect '{name}' "
              f"({worst(f[name]):.3f}x)")
    out["f32"] = f
    log(f"[{tag} f32] {f32_model}, full width, "
        f"f32, {f32_shape[0]} x {f32_shape[1]} tokens, lr "
        f"{SHARDED_F32_LR}: one-device loss {f['one_device']['loss']:.6f} "
        f"(step {f['one_device']['step_s']:.2f} s, peak "
        f"{f['one_device']['peak_mem_gb']:.2f} GB; "
        + (f"broadcast to the ranks in "
           f"{max(r['f32']['broadcast_s'] for r in ranks):.1f} s); "
           if "broadcast_s" in f else
           f"made before the ranks started, written for them in "
           f"{f['one_device']['write_s']:.1f} s); "
           if "write_s" in f["one_device"] else
           "run by each rank in turn); ")
        + "; ".join(f"{n}: loss err {f[n]['loss_err']:.2e}, worst param "
                    f"{f[n]['param_error_of_limit']:.3f}x the limit "
                    f"({f[n]['worst_leaf']})"
                    + (f", worst gradient {f[n]['grad_error_of_limit']:.3f}x"
                       f" ({f[n]['worst_grad_leaf']})"
                       if "grad_error_of_limit" in f[n] else "")
                    for n in f32_runs)
        + "; " + "; ".join(f"{n}: {worst(f[n]):.1f}x the limit"
                           for n in defects)
        + f" (atol / rtol {SHARDED_PARAM_TOL}, loss {SHARDED_LOSS_TOL})")
    return out


# ------------------------------------------ phases 3, 30-31: the VLM on a mesh

#: Llama-3.2-Vision-90B at a tp 2 rank: 32/4 heads x 128 and d_ff 14336
#: of 28672. Phase 30 serves phase 17's cut (20 layers) at tp 2 on phase
#: 27's two ranks; its f32 check, and phase 31's, at full width cut to one
#: self and one cross layer (``cross_attn_every=1, num_layers=2``, and the
#: unused trailing layer: 4.67 B params, 18.7 GB in f32)
VLM_TP_HEADS = (VLM_HEADS[0] // 2, VLM_HEADS[1] // 2, VLM_HEADS[2])
VLM_TP_MLP = (VLM_MLP[0], VLM_MLP[1] // 2)
VLM_F32_CUT = dict(cross_attn_every=1, num_layers=2)
VLM_TP_F32_NEW = 8
#: the f32 check's bound on the first prefill's logits (tp 2 against one
#: device: only the order of fp32 sums differs)
VLM_TP_LOGITS_TOL = 1e-3
#: phase 31: one group (4 self and 1 cross layer, the unused trailing one:
#: 7.235 B params) at dp 2 x tp 2 on phase 24's four ranks, FSDP + SP +
#: remat with Adafactor, gates open, 1 step (the script's time limit: a
#: step sends ~17 GB a rank through gloo; 2 until phases 32-33 joined) of
#: 2 x 1024 tokens beside a
#: (2, 1601, 8192) image block; its f32 check at ``VLM_F32_CUT`` on 2 x
#: 256 tokens and 2 image blocks, lr 1e-3, params at the reference test's
#: 5e-4 and the norms' and gates' gradients before clipping at atol 1e-6
#: + rtol 1e-3
VLM_SHARDED_LAYERS, VLM_SHARDED_STEPS = 5, 1
VLM_SHARDED_BATCH, VLM_SHARDED_SEQ = 2, 1024
VLM_SHARDED_RUNS = {"fsdp sp remat": dict(fsdp=True, seq_parallel=True,
                                          optimizer="adafactor")}
VLM_SHARDED_F32_BATCH, VLM_SHARDED_F32_SEQ = 2, 256
VLM_GRAD_LEAVES = ("ln1", "ln2", "lnx", "final_norm", "gate_attn",
                   "gate_mlp")
VLM_GRAD_ATOL, VLM_GRAD_RTOL = 1e-6, 1e-3
VLM_SHARDED_TIMEOUT_S = 600.0
#: the rank shapes flash takes in phase 31: a data rank's one row of 1024
#: tokens at a tp 2 rank's heads (bf16); the f32 check's one row of 256 at
#: a rank and its one-device step's two rows at all 64/8 heads
VLM_TRAIN_TP_FLASH = ((1, VLM_SHARDED_SEQ, VLM_SHARDED_SEQ) + VLM_TP_HEADS,)
VLM_TRAIN_TP_F32_FLASH = (
    (1, VLM_SHARDED_F32_SEQ, VLM_SHARDED_F32_SEQ) + VLM_TP_HEADS,
    (VLM_SHARDED_F32_BATCH, VLM_SHARDED_F32_SEQ, VLM_SHARDED_F32_SEQ)
    + VLM_HEADS)


def _vlm_mlp_weights(gen, dtype, f: int):
    """An MLP's weights of Llama-3.2-Vision-90B at d 8192 and ``f`` (a tp 2
    rank's 14336, or the whole 28672) at the uncut model's init scales
    (``w_down`` at 0.02 / sqrt(200), as phases 17 and 30 serve them)."""
    from repro_torch.configs import get_config
    d = VLM_MLP[0]
    layers = get_config("llama-3.2-vision-90b").num_layers
    wg, wu = ((torch.randn((d, f), generator=gen, device="cuda")
               * 0.02).to(dtype) for _ in range(2))
    wd = (torch.randn((f, d), generator=gen, device="cuda")
          * (0.02 / math.sqrt(2 * layers))).to(dtype)
    return wg, wu, wd


def _mlp_f32(gen, f: int, rows: int) -> dict:
    """The fp32 fused MLP (TF32 off) at d 8192, ``f``, ``rows`` rows per
    value against its plain version (atol 1e-5 + rtol 1e-4), shown to
    reject a dropped 64-wide f tile."""
    from repro_torch.kernels import fused_mlp as fm
    wg, wu, wd = _vlm_mlp_weights(gen, torch.float32, f)
    x = torch.randn((rows, VLM_MLP[0]), generator=gen, device="cuda")
    want = fm.fused_mlp_plain(x, wg, wu, wd)
    e = worst_excess(fm.fused_mlp(x, wg, wu, wd), want, 1e-5, 1e-4)
    wd[f // 2:f // 2 + 64] = 0
    bad = worst_excess(fm.fused_mlp_plain(x, wg, wu, wd), want, 1e-5, 1e-4)
    check(e <= 1.0, f"fused MLP fp32 at T={rows} d=8192 f={f}: worst error "
                    f"{e:.3f}x atol 1e-5 + rtol 1e-4")
    check(bad > 1.0, f"the fp32 MLP check at T={rows} f={f} passes a "
                     f"dropped f tile ({bad:.3f}x)")
    log(f"[mlp f32 T={rows} d=8192 f={f}] worst error {e:.3f}x the limit "
        f"(atol 1e-5, rtol 1e-4); a dropped 64-wide f tile would be "
        f"{bad:.1f}x")
    return {"t": rows, "d": VLM_MLP[0], "f": f, "dtype": "float32",
            "error_of_limit": e, "dropped_tile_error_of_limit": bad}


def phase_vlm_tp_kernels(seed: int):
    """Flash and the fused MLP at the rank shapes phases 30 and 31 give
    them. bf16, per value at phase 3's limits, each shown to reject its
    defect, timed beside SDPA / three matmuls with its bound: flash causal
    at (1, S, S, 32, 4, 128) for each of phase 17's prompt lengths (phase
    30's prefills) and at ``VLM_TRAIN_TP_FLASH`` (phase 31's forward, with
    its plain backward timed); the fused MLP at d 8192, f 14336 for the 4
    rows of a split-path decode step and each prompt length. fp32 (TF32
    off): flash at the f32 checks' shapes (phase 30's prefills at a rank's
    32/4 heads and at the one device's 64/8, phase 31's
    ``VLM_TRAIN_TP_F32_FLASH``) within phase 3's 2e-6, each rejecting
    dropped keys; the MLP at a rank's and the whole f for the decode step
    and the longest prompt (``_mlp_f32``). Inputs come from a generator of
    their own. Returns {kernel name: records}."""
    rng = np.random.default_rng(seed + 3031)
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    hq, hkv, d = VLM_TP_HEADS
    lens = vlm_prompt_lens(seed)
    serve = [_flash_shape(gen, (1, n, n, hq, hkv, d), 1e-5, 8e-3, timed=True)
             for n in lens]
    serve_f32 = tuple((1, n, n) + heads for n in (lens[0], lens[-1])
                      for heads in (VLM_TP_HEADS, VLM_HEADS))
    train = _training_flash(seed + 3131, VLM_TRAIN_TP_FLASH,
                            VLM_TRAIN_TP_F32_FLASH + serve_f32)
    wg, wu, wd = _vlm_mlp_weights(gen, torch.bfloat16, VLM_TP_MLP[1])
    mlp = [_mlp_rows(gen, rows, wg, wu, wd, 1e-3, 8e-3, timed=True)
           for rows in [4] + lens]
    del wg, wu, wd
    torch.cuda.empty_cache()
    mlp += [_mlp_f32(gen, f, rows) for f in (VLM_TP_MLP[1], VLM_MLP[1])
            for rows in (4, lens[-1])]
    torch.cuda.empty_cache()
    return {"flash_attention": {"vlm_tp2": serve,
                                "vlm_train_tp": train["flash_attention"]},
            "fused_mlp": {"vlm_tp2": mlp}}


def _vlm_serve_f32(cfg, seed: int, prompts, images, tag: str, tp=None):
    """The f32 check's run of phase 30 on one engine: on one device, or
    (``tp``) on this rank's shards through ``Session.serve(tp=)``, the
    weights drawn from ``seed`` either way (a rank draws only its blocks
    of them) with both gates open; the first request alone for one token
    (its prefill's logits kept), then the others for ``VLM_TP_F32_NEW``
    tokens each; launches counted from 0 just before the first step.
    Returns the first logits (on the host), the streams, the launches and
    what ``_vlm_want`` says of them."""
    from repro_torch import kernels
    from repro_torch.api import Session
    eng = Session(cfg, device="cuda", seed=seed).serve(tp=tp, slots=4,
                                                       max_len=1024)
    _open_gates(eng.params)
    kernels.reset_launches()
    eng.submit(0, prompts[0], max_new=1, images=images[0])
    eng.step()
    first = eng.last_logits.detach().float().cpu()
    for rid in range(1, len(prompts)):
        eng.submit(rid, prompts[rid], max_new=VLM_TP_F32_NEW,
                   images=images[rid])
    while eng.busy():
        eng.step()
    torch.cuda.synchronize()
    res = eng.results()
    check(all(res[r].done for r in res), f"[{tag}] unfinished requests")
    out = {"first": first,
           "streams": [list(res[r].out) for r in range(len(prompts))],
           "launches": kernels.launches(),
           "want": _vlm_want(cfg, eng.stats["prefills"],
                             eng.stats["decode_steps"])}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextmanager
def _dropped_cross_out_sum():
    """The defect: each cross layer's output projection without its sum
    over "model" (``attn_out`` in ``encdec.cross_out``): the rank adds its
    own heads' partial to the residual. The self layers keep theirs."""
    from repro_torch.models import encdec, vlm
    real_out, real_cross = encdec.attn_out, vlm._cross_block
    inside = []

    def out(p, ctx, cfg, *, sp=False):
        if not inside:
            return real_out(p, ctx, cfg, sp=sp)
        b, s = ctx.shape[:2]
        return ctx.reshape(b, s, -1) @ p["wo"]

    def cross(*args, **kw):
        inside.append(True)
        try:
            return real_cross(*args, **kw)
        finally:
            inside.pop()
    encdec.attn_out, vlm._cross_block = out, cross
    try:
        yield
    finally:
        encdec.attn_out, vlm._cross_block = real_out, real_cross


def _vlm_requests(seed: int, cfg):
    """Phase 17's six prompts and their images (``cfg``'s widths)."""
    _, prompts = serving_prompts(seed, cfg.vocab_size)
    return ([np.asarray(p, np.int32) for p in prompts],
            vlm_images(seed, len(prompts), cfg))


def _vlm_tp_rank(rank: int, world: int, seed: int):
    """One rank of phase 30, after phase 27's runs on the same rank
    process: Llama-3.2-Vision-90B at phase 17's cut through
    ``Session.serve(tp=)`` (the rank drawing only its shards from
    ``seed``; ``wo`` and ``w_down`` at the uncut model's init scale and
    the gates open, as phase 17 serves it) on phase 17's six requests
    with their images, 16 new tokens each, through ``_drive`` (launches
    counted from 0 just before: ``_vlm_want`` on the rank's shapes), its
    collectives and bytes by label; then the f32 check's runs at
    ``VLM_F32_CUT``: the rank's engine, and the same under
    ``_dropped_cross_out_sum``."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    _tp_rank_setup()
    full = get_config("llama-3.2-vision-90b")
    cfg = full.with_(num_layers=VLM_SERVE_LAYERS)
    prompts, images = _vlm_requests(seed, cfg)
    t0 = time.perf_counter()
    eng = Session(cfg, device="cuda", seed=seed).serve(tp=world, slots=4,
                                                       max_len=1024)
    _uncut_init_scales(_open_gates(eng.params), cfg, full.num_layers)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng._rank.counts.clear()
    eng._rank.bytes.clear()
    run = _drive(eng, prompts, VLM_NEW, f"vlm tp bf16 rank {rank}",
                 mixed=False, images=images)
    want = _vlm_want(cfg, run["prefills"], run["decode_steps"])
    check(run["launches"] == want,
          f"[vlm tp] rank {rank} launches {run['launches']} != {want}")
    held = {shape[1] for shape in vlm_flash_shapes(seed)}
    check(set(eng._prefill_lens) <= held,
          f"[vlm tp] prefill lengths {sorted(eng._prefill_lens)} not all "
          f"held by phase 3")
    run.update(rank=rank, build_s=build_s,
               heads=[eng._rank.heads, eng._rank.kv_heads],
               weights_gb=sum(v.numel() * v.element_size()
                              for v in _leaves(eng.params)) / 1e9,
               collectives=dict(eng._rank.counts),
               collective_bytes=dict(eng._rank.bytes))
    out = {"rank": rank, "bfloat16": run}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = full.with_(dtype="float32", **VLM_F32_CUT)
    prompts, images = _vlm_requests(seed, cfg32)
    out["float32"] = _vlm_serve_f32(cfg32, seed, prompts, images,
                                    f"vlm tp f32 rank {rank}", tp=world)
    with _dropped_cross_out_sum():
        out["defect"] = _vlm_serve_f32(cfg32, seed, prompts, images,
                                       f"vlm tp f32 defect rank {rank}",
                                       tp=world)
    for key in ("float32", "defect"):
        out[key]["first"] = out[key]["first"].numpy()
    return out


def _vlm_one_device_f32(seed: int):
    """Phase 30's f32 reference, run before the ranks start: the engine
    on one device at ``VLM_F32_CUT`` (TF32 off), freed after its run."""
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama-3.2-vision-90b").with_(dtype="float32",
                                                   **VLM_F32_CUT)
    prompts, images = _vlm_requests(seed, cfg)
    t0 = time.perf_counter()
    out = _vlm_serve_f32(cfg, seed, prompts, images, "vlm f32 one device")
    out["first"] = out["first"].numpy()
    out["wall_s"] = time.perf_counter() - t0
    return out


def phase_vlm_tp_serve(ranks, one: dict, single: dict, smi: str):
    """Phase 30: TENSOR-PARALLEL SERVING OF THE VLM — Llama-3.2-Vision-90B
    at full width (64/8 heads x 128, d_ff 28672, vocab 128,256, 1601
    image tokens) cut to phase 17's 20 layers (16 self and 4 cross, the
    unused trailing one; 20.07 B params), at tp 2 on phase 27's two rank
    processes (``_vlm_tp_rank``): each rank 32/4 heads of every self and
    cross layer, d_ff 14336 and half the vocabulary (~20 GB of bf16
    weights), phase 17's six requests and images, 16 new tokens each, the
    split path on dense rows (each rank's self K/V rows and image K/V of
    its 4 K/V heads). Checks on each rank: every request finishes with
    in-vocab tokens, launches as ``_vlm_want`` says, both ranks' streams
    equal, one ``attn_out`` and one ``mlp_out`` sum a self and a cross
    layer a program beside the embedding, logits and sampled-token sums
    and nothing else but the clock and the program checks. Reports
    tokens/s, step p50 with prefill and decode-only apart, collectives a
    program by label and their bytes, peak memory a rank, and the share of
    tokens equal to phase 17's streams (``single``; information: bf16
    sums the row-parallel partials in another order). Then the f32 check
    at full width, depth cut to one self and one cross layer
    (``VLM_F32_CUT``): both ranks' streams equal the one-device engine's
    (``one``, run and freed before the ranks started) and their first
    prefill's logits within ``VLM_TP_LOGITS_TOL``; a run without the
    cross layer's ``attn_out`` sum is outside it. Two ranks share one
    card's SMs and gloo stages each all-reduce through host memory: not
    tensor parallelism's speed."""
    from repro_torch.configs import get_config
    cfg = get_config("llama-3.2-vision-90b").with_(
        num_layers=VLM_SERVE_LAYERS)
    g, rest = cfg.vlm_groups
    layers = g * (cfg.cross_attn_every + 1) + rest
    note = ("two ranks share one card's SMs and gloo stages each "
            "all-reduce through host memory: not tensor parallelism's "
            "speed")
    out = {"note": note, "card": smi, "ranks": ranks,
           "one_device_f32": {k: v for k, v in one.items() if k != "first"}}
    r0 = ranks[0]["bfloat16"]
    for r in ranks:
        run, tag = r["bfloat16"], f"[vlm tp bf16] rank {r['rank']}"
        check(run["streams"] == r0["streams"],
              f"{tag} streams differ from rank 0's")
        programs = run["prefills"] + run["decode_steps"]
        c = run["collectives"]
        want = {"attn_out": layers * programs, "mlp_out": layers * programs,
                "embed": programs, "logits": programs, "tokens": programs}
        check({k: c.get(k, 0) for k in want} == want and set(c)
              <= set(want) | {"clock", "step_check"},
              f"{tag} collectives {c} != {want} (and the clock and step "
              f"checks)")
        check(run["heads"] == [VLM_TP_HEADS[0], VLM_TP_HEADS[1]],
              f"{tag} heads {run['heads']}")
        f32 = r["float32"]
        check(f32["launches"] == f32["want"],
              f"[vlm tp f32] rank {r['rank']} launches {f32['launches']} != "
              f"{f32['want']}")
        check(f32["streams"] == one["streams"],
              f"[vlm tp f32] rank {r['rank']} streams {f32['streams']} != "
              f"the one-device f32 engine's {one['streams']}")
        err = float(np.abs(f32.pop("first") - one["first"]).max())
        bad = float(np.abs(r["defect"].pop("first") - one["first"]).max())
        check(err <= VLM_TP_LOGITS_TOL,
              f"[vlm tp f32] rank {r['rank']} first logits {err:.3e} from "
              f"the one-device engine's (limit {VLM_TP_LOGITS_TOL})")
        check(bad > VLM_TP_LOGITS_TOL,
              f"[vlm tp f32] the check passes a run without the cross "
              f"layer's attn_out sum ({bad:.3e})")
        f32.update(first_logits_err=err, defect_first_logits_err=bad,
                   defect_streams_equal=r["defect"]["streams"]
                   == one["streams"])
    r0["agree_with_single"] = sum(
        a == b for got, want in zip(r0["streams"], single["streams"])
        for a, b in zip(got, want)) / r0["tokens"]
    programs = r0["prefills"] + r0["decode_steps"]
    per_program = {k: round(v / programs, 2)
                   for k, v in r0["collectives"].items()}
    mb = {k: round(v / 1e6, 2) for k, v in r0["collective_bytes"].items()}
    log(_run_text("vlm tp 2 bf16, rank 0", r0)
        + f"; {r0['heads'][0]}/{r0['heads'][1]} heads a rank, "
        f"{r0['weights_gb']:.2f} GB of weights a rank (built in "
        f"{r0['build_s']:.1f}s); peak memory a rank "
        f"{[round(x['bfloat16']['peak_mem_gb'], 2) for x in ranks]} GB; "
        f"collectives a program {per_program} (MB in all {mb}); "
        f"{r0['agree_with_single']:.1%} of tokens equal to phase 17's "
        f"streams (information) — {note}")
    f = ranks[0]["float32"]
    log(f"[vlm tp 2 f32] full width, {VLM_F32_CUT}: both ranks' streams "
        f"equal the one-device engine's over {len(one['streams'])} requests "
        f"(one device {one['wall_s']:.1f}s); first prefill's logits max abs "
        f"err {max(r['float32']['first_logits_err'] for r in ranks):.3e} "
        f"(limit {VLM_TP_LOGITS_TOL}); without the cross layer's attn_out "
        f"sum {min(r['float32']['defect_first_logits_err'] for r in ranks):.3e}"
        f" (streams equal: {f['defect_streams_equal']}); launches a rank "
        f"{f['launches']} on {smi}")
    out["bfloat16"], out["float32"] = r0, f
    return out


# -------------------------------------------------------------- phase 31

@contextmanager
def _dropped_data_sums():
    """The defect: no gradient sum over "data" — neither "dp_grads" (the
    leaves FSDP keeps whole) nor the sum in the backward of FSDP's
    gathers."""
    from repro_torch.core import tp
    real = tp._Assemble.apply

    def apply(part, r, axis, shape, where, what, summed):
        return real(part, r, axis, shape, where, what,
                    summed and axis != "data")
    tp._Assemble.apply = apply
    try:
        with _dropped_dp_grads():
            yield
    finally:
        del tp._Assemble.apply


@contextmanager
def _dropped_gate_sum():
    """The defect: under sequence parallelism the two gates without their
    backward "model" sum (each rank's gradient the partial of its slice
    of the sequence)."""
    from repro_torch.models import vlm
    real = vlm._gate
    vlm._gate = lambda cp, key, x, sp: real(cp, key, x, False)
    try:
        yield
    finally:
        vlm._gate = real


@contextmanager
def _dropped_cross_query_entry():
    """The defect: the cross query's ``region_in`` without its ``enter``
    (the sequence still gathered under SP): each rank's gradient into the
    residual stream from its query heads is a partial, never summed."""
    from repro_torch.core import tp
    real = tp.region_in

    def dropped(h, what, *, seq=False):
        if what != "xattn":
            return real(h, what, seq=seq)
        return tp.seq_gather(h, what + "_seq") if seq else h
    tp.region_in = dropped
    try:
        yield
    finally:
        tp.region_in = real


#: phase 31's f32 runs: name -> (mesh shape, Strategy keywords, defect or
#: None). The good run is the bf16 run's strategy at (2, 2) without remat
#: (the bf16 run has it; a recompute would gather the layers over gloo
#: once more); the "data" defect runs there too. The "model" defects run
#: at (1, 4) under SP without FSDP, beside a good run there: each rank
#: then holds its quarter of the model whole and a step sends no weights
#: through gloo (a (2, 2) FSDP step sends ~12 GB a rank in f32)
VLM_F32_SP = dict(seq_parallel=True, optimizer="adafactor", remat=False)
VLM_F32_FSDP = dict(VLM_F32_SP, fsdp=True)
VLM_F32_RUNS = {"(2, 2) fsdp sp": ((2, 2), VLM_F32_FSDP, None),
                "(1, 4) sp": ((1, 4), VLM_F32_SP, None)}
VLM_SHARDED_DEFECTS = {
    "(2, 2) fsdp sp, data gradient sums dropped":
        ((2, 2), VLM_F32_FSDP, _dropped_data_sums),
    "(1, 4) sp, gate gradient sums dropped":
        ((1, 4), VLM_F32_SP, _dropped_gate_sum),
    "(1, 4) sp, cross query's region_in dropped":
        ((1, 4), VLM_F32_SP, _dropped_cross_query_entry)}


@contextmanager
def _captured_grads(keep):
    """The train step's gradient update blocks before clipping, of each
    flat key ``keep`` accepts, copied to the host into the dict yielded."""
    from repro_torch.train import step as tstep
    from repro_torch.tree import flatten
    real = tstep.clip_by_global_norm
    got = {}

    def capture(g, max_norm, **kw):
        got.update({k: v.detach().float().cpu()
                    for k, v in flatten(g).items() if keep(k)})
        return real(g, max_norm, **kw)
    tstep.clip_by_global_norm = capture
    try:
        yield got
    finally:
        tstep.clip_by_global_norm = real


def _vlm_grad_leaf(key: str) -> bool:
    return key.rsplit("/", 1)[-1] in VLM_GRAD_LEAVES


def _vlm_f32_reference(cfg, seed: int, batch, views):
    """Phase 31's one-device f32 step (Adafactor, gates open), run by
    each rank in turn alone on the card (a barrier between turns): the
    rank keeps, on the host, its blocks of the new params and of the
    norms' and gates' gradients before clipping under each of ``views``
    ({mesh shape: (training rank, its coordinate)}), and nothing else —
    no 18.7 GB broadcast."""
    import torch.distributed as dist
    from repro_torch.core import tp
    from repro_torch.core.strategy import Strategy
    from repro_torch.params import init_params
    from repro_torch.train import step as tstep
    from repro_torch.tree import flatten
    out = {}
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            gc.collect()
            torch.cuda.empty_cache()
            st = Strategy(dtype="float32", optimizer="adafactor",
                          remat=False)
            params = _open_gates(init_params(cfg, device="cuda",
                                             seed=seed + 1))
            step = tstep.make_train_step(cfg, st, lr=SHARDED_F32_LR)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _captured_grads(_vlm_grad_leaf) as got:
                new, opt, m = step(params, tstep.init_opt_state(params, st),
                                   batch)
            torch.cuda.synchronize()
            out["one_device"] = {
                "step_s": time.perf_counter() - t0,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
            flat = flatten(new)
            for shape, (view, coord) in views.items():
                out[shape] = (
                    {k: tp.shard_leaf(v.detach(), view.leaves[k].spec,
                                      view.axes, coord).cpu()
                     for k, v in flat.items()},
                    {k: tp.shard_leaf(g, view.leaves[k].update, view.axes,
                                      coord) for k, g in got.items()})
            del params, new, opt, step, m, flat
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _vlm_sharded_f32_rank(meshes, seed: int, data):
    """Phase 31's f32 check on this rank (TF32 off), at ``VLM_F32_CUT``
    with the gates open: the one-device reference (``_vlm_f32_reference``),
    then each of ``VLM_F32_RUNS`` and ``VLM_SHARDED_DEFECTS`` on the
    rank's shards (``meshes``: {shape: DeviceMesh}): the run's worst param
    error of the reference test's 5e-4, worst gradient error of
    ``VLM_GRAD_ATOL`` + ``VLM_GRAD_RTOL``, its loss's distance and its
    step's seconds."""
    from repro_torch.configs import get_config
    from repro_torch.core import tp
    from repro_torch.core.strategy import Strategy
    from repro_torch.params import full_shapes, init_params
    from repro_torch.train import step as tstep
    from repro_torch.tree import flatten
    cfg = get_config("llama-3.2-vision-90b").with_(dtype="float32",
                                                   **VLM_F32_CUT)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    shapes = full_shapes(cfg)
    runs = {**VLM_F32_RUNS, **VLM_SHARDED_DEFECTS}
    views = {}
    for shape, kw, _ in runs.values():
        if shape not in views:
            views[shape] = (tp.Rank.of(meshes[shape], cfg,
                                       Strategy(dtype="float32", **kw),
                                       shapes),
                            tp.coordinate(meshes[shape]))
    ref = _vlm_f32_reference(cfg, seed, batch, views)
    out = {"one_device": ref["one_device"]}
    for name, (shape, kw, defect) in runs.items():
        mesh = meshes[shape]
        st = Strategy(dtype="float32", **kw)
        rank = tp.Rank.of(mesh, cfg, st, shapes)
        params = _open_gates(init_params(cfg, device="cuda", seed=seed + 1,
                                         shard=(st, mesh)))
        step = tstep.make_train_step(cfg, st, lr=SHARDED_F32_LR)
        want, want_grads = ref[shape]
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (defect or nullcontext)(), tp.active(rank), \
                _captured_grads(_vlm_grad_leaf) as got:
            opt = tstep.init_opt_state(params, st)
            new, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        worst, worst_key = 0.0, None
        for key, block in flatten(new).items():
            e = _chunked_excess(block.detach(), want[key], SHARDED_PARAM_TOL,
                                SHARDED_PARAM_TOL)
            if e > worst:
                worst, worst_key = e, key
        gworst, gkey = 0.0, None
        for key, g in got.items():
            e = worst_excess(g, want_grads[key], VLM_GRAD_ATOL,
                             VLM_GRAD_RTOL)
            if e > gworst:
                gworst, gkey = e, key
        out[name] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "step_s": step_s,
                     "param_error_of_limit": worst, "worst_leaf": worst_key,
                     "grad_error_of_limit": gworst, "worst_grad_leaf": gkey,
                     "loss_err": abs(float(m["loss"])
                                     - ref["one_device"]["loss"])}
        del params, new, opt, step, m, got
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _vlm_sharded_rank(rank: int, mesh, seed: int, f32_data):
    """One rank of phase 31, after phase 29 on the same rank processes:
    the bf16 run (``VLM_SHARDED_RUNS``: a Trainer drawing only its shards,
    the gates opened before the first step, ``ImagesData`` from ``seed``),
    then the f32 check (``_vlm_sharded_f32_rank``) on ``mesh`` and a (1,
    4) mesh of the same ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import ImagesData
    cfg = get_config("llama-3.2-vision-90b").with_(
        num_layers=VLM_SHARDED_LAYERS)
    out = {}
    t0 = time.perf_counter()
    for name in VLM_SHARDED_RUNS:
        data = ImagesData(cfg, global_batch=VLM_SHARDED_BATCH,
                          seq_len=VLM_SHARDED_SEQ, seed=seed)
        out[name] = _sharded_bf16_run(
            mesh, cfg, name, seed, steps=VLM_SHARDED_STEPS,
            batch=VLM_SHARDED_BATCH, seq=VLM_SHARDED_SEQ, data=data,
            runs=VLM_SHARDED_RUNS, prepare=_open_gates)
        _rank_log(rank, f"{name} done at {time.perf_counter() - t0:.1f}s: "
                        f"steps {[round(x, 3) for x in out[name]['step_s']]}"
                        f" s, peak {out[name]['peak_mem_gb']:.2f} GB",
                  "vlm sharded train")
    meshes = {tuple(SHARDED_MESH): mesh,
              (1, 4): make_mesh((1, 4), ("data", "model"))}
    out["f32"] = _vlm_sharded_f32_rank(meshes, seed, f32_data)
    _rank_log(rank, f"f32 check done at {time.perf_counter() - t0:.1f}s "
                    f"(one-device step {out['f32']['one_device']['step_s']:.1f}"
                    f" s): " + ", ".join(
                        f"{k} {v['step_s']:.1f}s" for k, v in out["f32"].items()
                        if k != "one_device"), "vlm sharded train")
    return out


def phase_vlm_train_sharded(ranks, smi: str):
    """Phase 31: SHARDED TRAINING OF THE VLM, on phase 24's four rank
    processes after phase 29 (``_vlm_sharded_rank``):
    Llama-3.2-Vision-90B at full width cut to one group
    (``VLM_SHARDED_LAYERS``: 4 self and 1 cross layer and the unused
    trailing one, 7.235 B params) at dp 2 x tp 2 under FSDP, sequence
    parallelism and remat with Adafactor, gates open, 1 step of 2 x 1024
    tokens beside a (2, 1601, 8192) image block (``ImagesData``): only
    FSDP fits four ranks on the card (ZeRO-1 would hold ~7.2 GB of bf16
    params and as much of gradients a rank). Checks (``_sharded_checks``):
    flash once a self layer a step and once more for the remat recompute
    (a data rank's (1, 1024, 1024, 32, 4, 128)), the other kernels never;
    the same metrics on every rank, the data replicas' whole blocks (the
    gates) equal bit for bit. Then the f32 check at ``VLM_F32_CUT``
    (``VLM_F32_RUNS``) with three defects outside its bounds
    (``VLM_SHARDED_DEFECTS``): no "data" gradient sum, no gate sum under
    SP, and the cross query's ``region_in`` without its ``enter``."""
    from repro_torch.configs import get_config
    cfg = get_config("llama-3.2-vision-90b").with_(
        num_layers=VLM_SHARDED_LAYERS)
    g, rest = cfg.vlm_groups
    selfs = g * cfg.cross_attn_every + rest
    want = {"flash_attention": VLM_SHARDED_STEPS * 2 * selfs,
            "fused_mlp": 0, "paged_attention": 0, "ssd_scan": 0}
    runs = [dict(r.pop("vlm"), rank=r["rank"], coord=r["coord"])
            for r in ranks]
    out = _sharded_checks(
        runs, f"Llama-3.2-Vision-90B {VLM_SHARDED_LAYERS} layers",
        f"Llama-3.2-Vision-90B {VLM_F32_CUT}", want, VLM_SHARDED_DEFECTS,
        smi, "vlm sharded train", steps=VLM_SHARDED_STEPS,
        batch=VLM_SHARDED_BATCH, seq=VLM_SHARDED_SEQ,
        f32_shape=(VLM_SHARDED_F32_BATCH, VLM_SHARDED_F32_SEQ),
        runs_by_name=VLM_SHARDED_RUNS, f32_runs=VLM_F32_RUNS)
    out["ranks"] = runs
    return out


# ----------------------------------------------------------- phase 25

#: phase 25: GPipe over a (1, 4, 1) ("data", "pipe", "model") mesh of four
#: gloo rank processes on the card (phase 24's), Qwen3-14B at full width
#: cut to 8 layers, 2 a stage; M microbatches of 1 x 2048 hidden states
PIPE_MESH, PIPE_LAYERS, PIPE_SEQ, PIPE_MS = (1, 4, 1), 8, 2048, (1, 4, 8)
PIPE_REPEATS = 2
#: its f32 check: 1 layer a stage, M 4 microbatches of 1 x 256; output at
#: the reference test's atol / rtol 1e-5, gradients at its atol 1e-5 (of
#: each tensor's largest value: see ``_pipe_f32``) and rtol 1e-4
PIPE_F32_LAYERS, PIPE_F32_SEQ, PIPE_F32_M = 4, 256, 4
PIPE_OUT_TOL, PIPE_GRAD_ATOL, PIPE_GRAD_RTOL = 1e-5, 1e-5, 1e-4
#: the seconds phase 25 adds to phase 24's rank processes
PIPE_TIMEOUT_S = 300.0
#: flash's shapes there: a stage's (1, 2048) microbatch at all 40/8 heads
#: (bf16), the f32 check's (1, 256)
PIPE_FLASH = (1, PIPE_SEQ, PIPE_SEQ, 40, 8, 128)
PIPE_F32_FLASH = ((1, PIPE_F32_SEQ, PIPE_F32_SEQ, 40, 8, 128),)


def phase_pipe_kernels(seed: int):
    """Flash at the shapes phase 25 gives it (``_training_flash``); the
    fused MLP's T 2048 at d 5120, f 17408 is phase 3's."""
    return _training_flash(seed + 2528, (PIPE_FLASH,), PIPE_F32_FLASH)


def _pipe_layers(cfg, layers, seed: int):
    """Layers ``layers`` of phase 25's weights, stacked: ``{key: (len(
    layers), ...)}`` by the dense block's keys, each layer drawn from its
    own seed, so every rank draws the same layer j."""
    from repro_torch.params import FIXED_INITS, _block_spec
    spec = _block_spec(cfg, "s", ())
    out = {k[2:]: torch.empty((len(layers),) + shape, dtype=dt,
                              device="cuda")
           for k, (shape, dt, _) in spec.items()}
    for i, j in enumerate(layers):
        gen = torch.Generator(device="cuda").manual_seed(seed * 1000 + j)
        for k, (shape, dt, init) in spec.items():
            out[k[2:]][i] = FIXED_INITS[init](shape) if isinstance(init, str) \
                else torch.randn(shape, generator=gen, device="cuda") * init
    return out


def _pipe_stage_fn(cfg, per: int):
    """``per`` of the port's ``transformer.block``s; with a gradient each
    is rematerialised in the backward (GPipe's re-materialisation: the
    four ranks' saved activations at M 8 would not fit 60 GB)."""
    from repro_torch.core import tp
    from repro_torch.models.transformer import block, unstack

    def layer(lp, h):
        return block(lp, h, cfg)[0]

    def stage_fn(local, h):
        for lp in unstack(local, per):
            h = tp.checkpoint(layer, lp, h) if torch.is_grad_enabled() \
                else layer(lp, h)
        return h
    return stage_fn


def _pipe_tree(own: dict, p: int):
    """The (P, ...) stage tree a rank hands ``pipeline_apply``: a rank
    reads only its own stage's slice, so every slice is a stride-0 view
    of its own layers (not P stages' weights)."""
    from repro_torch.tree import unflatten
    return unflatten({k: v.expand((p,) + v.shape) for k, v in own.items()})


def _pipe_bf16(rank: int, mesh, seed: int):
    """Phase 25's bf16 runs on this rank: a ``no_grad`` forward and a
    forward + backward of ``(y ** 2).mean()`` at each M, ``PIPE_REPEATS``
    times, launches and moves counted from 0 around each run; then, on
    the first rank alone (the others wait at a barrier), the one-device
    sequential application of all 8 layers per microbatch, forward and
    forward + backward, whose outputs the pipeline's must equal and whose
    time a microbatch is the schedule's ideal."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline
    cfg = get_config("qwen3-14b").with_(num_layers=PIPE_LAYERS)
    p = PIPE_MESH[1]
    per = PIPE_LAYERS // p
    stage = pipeline.Stage.of(mesh)
    own = _pipe_layers(cfg, range(stage.index * per, (stage.index + 1) * per),
                       seed)
    stage_fn = _pipe_stage_fn(cfg, per)
    gen = torch.Generator(device="cuda").manual_seed(seed + 25)
    x = torch.randn((max(PIPE_MS), PIPE_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run(m: int, grad: bool):
        for v in own.values():
            v.requires_grad_(grad)
            v.grad = None
        with torch.set_grad_enabled(grad):
            y = pipeline.pipeline_apply(stage_fn, _pipe_tree(own, p), x[:m],
                                        mesh=mesh,
                                        num_microbatches=m, stage=stage)
            if grad:
                (y.float() ** 2).mean().backward()
        return y.detach()

    for grad in (False, True):                      # warm up, uncounted
        run(1, grad)
    out = {"stage": stage.index, "runs": {}}
    keep = {}
    for grad in (False, True):
        for m in PIPE_MS:
            name = f"{'fwd+bwd' if grad else 'no_grad'} M{m}"
            rec = {"step_s": [], "fingerprints": []}
            for _ in range(PIPE_REPEATS):
                stage.counts.clear()
                stage.bytes.clear()
                kernels.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = run(m, grad)
                torch.cuda.synchronize()
                rec["step_s"].append(time.perf_counter() - t0)
                rec["launches"] = kernels.launches()
                rec["fingerprints"].append(_fingerprint(y))
            rec["moves"] = dict(stage.counts)
            rec["move_bytes"] = dict(stage.bytes)
            rec["finite"] = bool(torch.isfinite(y).all())
            out["runs"][name] = rec
            keep[name] = y
            _rank_log(rank, f"pipeline {name}: steps "
                            f"{[round(s, 3) for s in rec['step_s']]} s",
                      "pipeline")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del own
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        out["sequential"] = _pipe_sequential(cfg, seed, x, keep)
    else:
        del keep
    dist.barrier()
    return out


def _pipe_sequential(cfg, seed: int, x, keep: dict):
    """The first rank's one-device run of phase 25's 8 layers on each
    microbatch in turn: ``no_grad`` and forward + backward, each twice
    (the second timed); whether each pipeline output equals it bit for
    bit, and its largest |difference|."""
    weights = _pipe_layers(cfg, range(PIPE_LAYERS), seed)
    stage_fn = _pipe_stage_fn(cfg, PIPE_LAYERS)
    m_all = max(PIPE_MS)
    out = {}
    for grad in (False, True):
        for v in weights.values():
            v.requires_grad_(grad)
        for _ in range(2):
            for v in weights.values():
                v.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ys = []
            for i in range(m_all):
                with torch.set_grad_enabled(grad):
                    y = stage_fn(weights, x[i:i + 1])
                    if grad:
                        (y.float() ** 2).mean().backward()
                ys.append(y.detach())
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        mode = "fwd+bwd" if grad else "no_grad"
        seq = torch.cat(ys)
        out[mode] = {"ms_per_microbatch": dt * 1e3 / m_all}
        for m in PIPE_MS:
            got = keep[f"{mode} M{m}"]
            out[f"{mode} M{m}"] = {
                "equal": bool(torch.equal(got, seq[:m])),
                "max_abs_err": (got.float() - seq[:m].float()).abs().max()
                .item()}
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pipe_f32(rank: int, mesh, seed: int):
    """Phase 25's f32 check on this rank (TF32 off): ``PIPE_F32_LAYERS``
    layers, one a stage, M ``PIPE_F32_M`` microbatches of 1 x
    ``PIPE_F32_SEQ``. First this rank's own one-device sequential run of
    all the layers, a microbatch at a time (the gradients of
    ``(y ** 2).mean()`` kept for its stage's layers only); then the
    pipeline's output and its stage's gradients, and the same with the
    backward ring broken (each gradient sent on to the NEXT stage: the
    defect), each held to it. At full width a gradient's values are
    ~1e-7 to 1e-5, so the reference's atol 1e-5 would pass anything: it
    is taken relative to each tensor's largest value, the rtol as it
    is; the output (values ~1) keeps the absolute bounds."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline
    cfg = get_config("qwen3-14b").with_(num_layers=PIPE_F32_LAYERS,
                                        dtype="float32")
    p = PIPE_MESH[1]
    per = PIPE_F32_LAYERS // p
    stage = pipeline.Stage.of(mesh)
    lo, hi = stage.index * per, (stage.index + 1) * per
    gen = torch.Generator(device="cuda").manual_seed(seed + 2525)
    x = torch.randn((PIPE_F32_M, PIPE_F32_SEQ, cfg.d_model), generator=gen,
                    device="cuda")
    full = _pipe_layers(cfg, range(PIPE_F32_LAYERS), seed + 1)
    parts = [({k: v[:lo] for k, v in full.items()}, lo),
             ({k: v[lo:hi].detach().requires_grad_() for k, v in
               full.items()}, per),
             ({k: v[hi:] for k, v in full.items()}, PIPE_F32_LAYERS - hi)]
    ys = []
    for i in range(PIPE_F32_M):
        # every layer then runs its gradient path (the plain SwiGLU), as
        # every stage of the pipeline does: its input carries the ring's
        h = x[i:i + 1].detach().requires_grad_()
        for part, n in parts:
            h = _pipe_stage_fn(cfg, n)(part, h)
        ((h ** 2).sum() / x.numel()).backward()
        ys.append(h.detach())
    want_y = torch.cat(ys)
    want_g = {k: v.grad for k, v in parts[1][0].items()}
    del full, parts, ys
    gc.collect()
    torch.cuda.empty_cache()
    real = pipeline._shift

    def broken(t, st, what, forward):        # the defect: no inverse ring
        return real(t, st, what, forward or what.endswith(".grad"))

    out = {"stage": stage.index}
    stage_fn = _pipe_stage_fn(cfg, per)
    for name, shift in (("pipeline", real), ("backward ring broken", broken)):
        own = _pipe_layers(cfg, range(lo, hi), seed + 1)
        for v in own.values():
            v.requires_grad_(True)
        pipeline._shift = shift
        try:
            y = pipeline.pipeline_apply(stage_fn, _pipe_tree(own, p), x,
                                        mesh=mesh,
                                        num_microbatches=PIPE_F32_M,
                                        stage=stage)
            (y ** 2).mean().backward()
        finally:
            pipeline._shift = real
        rec = {"stage": stage.index, "grads": {},
               "output_error_of_limit": worst_excess(
                   y.detach(), want_y, PIPE_OUT_TOL, PIPE_OUT_TOL)}
        worst = 0.0
        for k, v in own.items():
            w = want_g[k]
            scale = w.abs().max().item()
            e = worst_excess(v.grad, w, PIPE_GRAD_ATOL * scale,
                             PIPE_GRAD_RTOL) if scale > 0 \
                else float((v.grad != 0).any())
            rec["grads"][k] = {"error_of_limit": e, "scale": scale,
                               "max_abs_err": (v.grad - w).abs().max()
                               .item()}
            worst = max(worst, e)
        rec["grad_error_of_limit"] = worst
        out[name] = rec
        del own, y
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _pipe_rank(rank: int, seed: int):
    """Phase 25 on this rank of phase 24's spawn: the bf16 runs, then the
    f32 check, on a (1, 4, 1) pipeline mesh."""
    from repro_torch.launch.mesh import make_pipeline_mesh
    t0 = time.perf_counter()
    mesh = make_pipeline_mesh(data=PIPE_MESH[0], pipe=PIPE_MESH[1],
                              model=PIPE_MESH[2])
    out = _pipe_bf16(rank, mesh, seed)
    _rank_log(rank, f"bf16 runs done at {time.perf_counter() - t0:.1f}s",
              "pipeline")
    out["f32"] = _pipe_f32(rank, mesh, seed)
    out["wall_s"] = time.perf_counter() - t0
    _rank_log(rank, f"f32 check done at {out['wall_s']:.1f}s", "pipeline")
    return out


def phase_pipeline(ranks, smi: str):
    """Phase 25: GPIPE PIPELINE PARALLELISM of Qwen3-14B at full width
    (40/8 heads x 128, d_ff 17408; depth cut to ``PIPE_LAYERS``, 2 a
    stage) over a (1, 4, 1) ("data", "pipe", "model") mesh: phase 24's
    four gloo rank processes on the card, each one stage.
    ``core/pipeline.py::pipeline_apply`` with the port's own
    ``transformer.block`` as the stage function, on M = 1, 4 and 8
    microbatches of 1 x 2048 seeded hidden states: a ``no_grad`` forward
    (flash and the fused MLP each launched 2 x (M + 3) times a rank) and
    a forward + backward of ``(y ** 2).mean()``, each block
    rematerialised (flash 2 x 2 x (M + 3), the plain SwiGLU),
    ``PIPE_REPEATS`` times each. Checks: every rank's
    output equal bit for bit to the first rank's and across repeats,
    finite, and equal bit for bit to the one-device sequential run of the
    same 8 layers per microbatch (the same kernels on the same shapes);
    T = M + 3 stage moves a forward, T - 1 a backward, one output copy;
    then the f32 check (1 layer a stage, M 4 x 256 tokens): output within
    atol / rtol 1e-5 and every stage gradient within atol 1e-5 (of the
    tensor's largest value) + rtol 1e-4 of the one-device run, and the
    backward ring broken outside them. Prints step time by M, ms a
    microbatch against the one-device ideal beside the schedule's (M + P
    - 1) / M, moves and bytes by label and peak memory a rank. Four
    ranks share one card's SMs and gloo stages every move through host
    memory: not pipeline parallelism's speed."""
    from repro_torch.core.pipeline import simulate_schedule
    note = ("four ranks share one card's SMs and gloo stages every move "
            "through host memory: not pipeline parallelism's speed")
    p = PIPE_MESH[1]
    per = PIPE_LAYERS // p
    r0 = ranks[0]
    seq = r0["sequential"]
    out = {"note": note, "card": smi, "ranks": ranks, "runs": {}}
    for name, rec0 in r0["runs"].items():
        mode, m = name.split(" M")
        m = int(m)
        ticks = m + p - 1
        want = {"flash_attention": ticks * per * (2 if mode == "fwd+bwd"
                                                  else 1),
                "fused_mlp": 0 if mode == "fwd+bwd" else ticks * per,
                "paged_attention": 0, "ssd_scan": 0}
        moves = {"pipe_send": ticks, "pipe_out": 1}
        if mode == "fwd+bwd":
            moves["pipe_send.grad"] = ticks - 1
        for r in ranks:
            run, tag = r["runs"][name], f"[pipeline {name}] rank {r['rank']}"
            check(run["launches"] == want,
                  f"{tag} launches {run['launches']} != {want}")
            check(run["moves"] == moves, f"{tag} moves {run['moves']} != "
                                         f"{moves}")
            check(run["finite"], f"{tag}: output not finite")
            check(run["fingerprints"] == [rec0["fingerprints"][0]]
                  * PIPE_REPEATS, f"{tag}: output differs from rank 0's "
                                  f"first or between repeats")
        eq = seq[name]
        check(eq["equal"], f"[pipeline {name}] output differs from the "
                           f"one-device sequential run (max abs "
                           f"{eq['max_abs_err']})")
        p50 = float(np.percentile(rec0["step_s"], 50))
        ideal = seq[mode]["ms_per_microbatch"]
        per_mb = p50 * 1e3 / m
        sim = simulate_schedule(p, m)
        out["runs"][name] = {
            "step_p50_s": p50, "step_s": rec0["step_s"],
            "ms_per_microbatch": per_mb, "ideal_ms_per_microbatch": ideal,
            "of_ideal": per_mb / ideal,
            "schedule_of_ideal": sim["total_time"] / sim["ideal_time"],
            "simulated_bubble": sim["bubble_fraction"],
            "measured_bubble": 1.0 - ideal / per_mb,
            "moves": rec0["moves"],
            "move_mb": {k: v / 1e6 for k, v in rec0["move_bytes"].items()}}
        rec = out["runs"][name]
        log(f"[pipeline {name}] Qwen3-14B {PIPE_LAYERS} layers over {p} "
            f"stages, full width, {m} x 1 x {PIPE_SEQ} tokens on {smi}: step "
            f"p50 {p50:.3f} s ({[round(s, 3) for s in rec0['step_s']]}), "
            f"{per_mb:.1f} ms a microbatch = {rec['of_ideal']:.3f}x the "
            f"one-device {ideal:.1f} ms (the simulator's GPipe (M + P - 1) "
            f"/ M = {rec['schedule_of_ideal']:.3f}; bubble measured "
            f"{rec['measured_bubble']:.3f}, simulated "
            f"{rec['simulated_bubble']:.3f}); equal bit for bit to the one-device run on "
            f"every rank; moves {rec0['moves']}, MB "
            f"{ {k: round(v, 1) for k, v in rec['move_mb'].items()} }; "
            f"launches {rec0['launches']} — {note}")
    out["peak_mem_gb_ranks"] = [r["peak_mem_gb"] for r in ranks]
    check(sum(out["peak_mem_gb_ranks"]) < 60.0,
          f"[pipeline] the four ranks peak at {out['peak_mem_gb_ranks']} GB")
    log(f"[pipeline] peak memory a rank "
        f"{[round(x, 2) for x in out['peak_mem_gb_ranks']]} GB on {smi}; "
        f"phase 25 took {r0['wall_s']:.1f} s of the rank processes")
    f32 = {name: max((r["f32"][name] for r in ranks),
                     key=lambda rec: rec["grad_error_of_limit"])
           for name in ("pipeline", "backward ring broken")}
    good, bad = f32["pipeline"], f32["backward ring broken"]
    out_err = max(r["f32"]["pipeline"]["output_error_of_limit"]
                  for r in ranks)
    scales = sorted(g["scale"] for r in ranks
                    for g in r["f32"]["pipeline"]["grads"].values())
    out["f32"] = dict(f32, output_error_of_limit=out_err)
    log(f"[pipeline f32] Qwen3-14B {PIPE_F32_LAYERS} layers over {p} stages, "
        f"full width, f32, {PIPE_F32_M} x 1 x {PIPE_F32_SEQ} tokens: output "
        f"worst {out_err:.3f}x atol / rtol {PIPE_OUT_TOL}, stage gradients "
        f"worst {good['grad_error_of_limit']:.3f}x (atol {PIPE_GRAD_ATOL} of "
        f"each tensor's largest value, {scales[0]:.3e}-{scales[-1]:.3e}, "
        f"rtol {PIPE_GRAD_RTOL}); the backward ring broken: "
        f"{bad['grad_error_of_limit']:.1f}x")
    check(out_err <= 1.0, f"[pipeline f32] output at {out_err:.3f}x atol / "
                          f"rtol 1e-5")
    check(good["grad_error_of_limit"] <= 1.0,
          f"[pipeline f32] stage {good['stage']} gradients at "
          f"{good['grad_error_of_limit']:.3f}x the limit")
    check(bad["grad_error_of_limit"] > 1.0,
          f"[pipeline f32] the check passes a broken backward ring "
          f"({bad['grad_error_of_limit']:.3f}x)")
    return out


# ------------------- phases 3, 32-33: OLMoE with TP inside each expert

#: TP inside each expert (``Strategy(expert_parallel=False)``): every
#: expert on every rank, each expert's d_ff over "model"
MOE_TIE = dict(expert_parallel=False)
#: phase 32: OLMoE-1B-7B uncut at tp 2 with ``MOE_TIE`` (all 64 experts and
#: 512 of each expert's 1024 d_ff a rank) on phase 21's two rank
#: processes, phase 13's settings and requests on the mixed step; its f32
#: check at full width cut to 1 of 16 layers (the script's time limit),
#: 8 new tokens a request
MOE_TIE_NEW, MOE_TIE_F32_LAYERS, MOE_TIE_F32_NEW = 16, 1, 8
MOE_TIE_TIMEOUT_S = 300.0
#: phase 33: OLMoE-1B-7B at full width cut to 2 of 16 layers, dp 2 x tp 2
#: on phase 24's four rank processes after phase 31 (warm from its
#: runs): two AdamW runs (remat on) of ``MOE_SHARDED_STEPS`` step (the
#: script's time limit) on 2 x 2048 tokens that
#: differ in the MoE's layout alone; its f32 check at 1 layer, full
#: width, on 2 x 256 tokens: TP inside each expert and SP at (2, 2)
#: against the one-device step made before phase 24's ranks start, params
#: at the reference test's 5e-4 and the router's gradient before clipping
#: at atol 1e-6 + rtol 1e-3 (phase 31's gradient bound)
MOE_SHARDED_LAYERS, MOE_SHARDED_STEPS, MOE_SHARDED_F32_LAYERS = 2, 1, 1
MOE_SHARDED_RUNS = {"ep zero1": {}, "tie zero1": dict(MOE_TIE)}
MOE_F32_SP = dict(MOE_TIE, seq_parallel=True, remat=False)
MOE_F32_RUNS = {"tie sp": MOE_F32_SP}
MOE_SHARDED_TIMEOUT_S = 300.0
#: the rank shapes flash takes in phase 33: a data rank's one row of 2048
#: tokens at a tp 2 rank's 8/8 heads (bf16); the f32 check's row of 256 at
#: a rank and its one-device step's two rows at all 16/16 heads
MOE_TRAIN_TP_FLASH = ((1, SHARDED_SEQ, SHARDED_SEQ) + OLMOE_TP2_HEADS
                      + (128,),)
MOE_TRAIN_TP_F32_FLASH = (
    (1, SHARDED_F32_SEQ, SHARDED_F32_SEQ) + OLMOE_TP2_HEADS + (128,),
    (SHARDED_BATCH, SHARDED_F32_SEQ, SHARDED_F32_SEQ) + MOE_HEADS + (128,))


def phase_moe_train_tp_kernels(seed: int):
    """Flash at the shapes phase 33 gives it: bf16 at
    ``MOE_TRAIN_TP_FLASH`` and fp32 at ``MOE_TRAIN_TP_F32_FLASH``
    (``_training_flash``)."""
    return _training_flash(seed + 3333, MOE_TRAIN_TP_FLASH,
                           MOE_TRAIN_TP_F32_FLASH)


@contextmanager
def _dropped_moe_out_sum():
    """The defect: TP inside each expert without its ``moe_out`` sum over
    "model" (under SP the rank's slice of its own partial): each rank adds
    its partial over d_ff to the residual."""
    from repro_torch.core import tp
    real = tp.reduce_out

    def dropped(x, what, *, seq=False):
        if what != "moe_out":
            return real(x, what, seq=seq)
        return tp.seq_split(x, what) if seq else x
    tp.reduce_out = dropped
    try:
        yield
    finally:
        tp.reduce_out = real


@contextmanager
def _dropped_gate_entry():
    """The defect: the gates of TP inside each expert without their
    ``enter`` (``moe_gate``): each rank's gate gradient is its partial
    over its d_ff, never summed."""
    from repro_torch.core import tp
    real = tp.enter
    tp.enter = lambda x, what: x if what == "moe_gate" else real(x, what)
    try:
        yield
    finally:
        tp.enter = real


def _moe_serve_f32(cfg, seed: int, prompts, tag: str, tp=None):
    """Phase 32's f32 run on one engine: on one device, or (``tp``) with
    TP inside each expert on this rank's shards through
    ``Session.serve(tp=)``, the weights drawn from ``seed`` either way, on
    phase 13's settings (the mixed step); the first request alone for one
    token (the logits of its last program kept), then the others for
    ``MOE_TIE_F32_NEW`` tokens each; launches counted from 0 just before
    the first step. Returns the first logits (on the host), the streams,
    the launches and what ``_family_want`` says of them."""
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.core.strategy import Strategy
    st = Strategy(dtype=cfg.dtype, **MOE_TIE) if tp else None
    eng = Session(cfg, strategy=st, device="cuda", seed=seed).serve(
        tp=tp, slots=4, max_len=1024, page_size=16, chunk_tokens=256)
    kernels.reset_launches()
    eng.submit(0, prompts[0], max_new=1)
    while eng.busy():
        eng.step()
    first = eng.last_logits.detach().float().cpu()
    for rid in range(1, len(prompts)):
        eng.submit(rid, prompts[rid], max_new=MOE_TIE_F32_NEW)
    while eng.busy():
        eng.step()
    torch.cuda.synchronize()
    res = eng.results()
    check(all(res[r].done for r in res), f"[{tag}] unfinished requests")
    out = {"first": first,
           "streams": [list(res[r].out) for r in range(len(prompts))],
           "launches": kernels.launches(), "want": _family_want(eng, cfg)}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _moe_one_device_f32(seed: int):
    """Phase 32's f32 reference, run before phase 21's ranks start: the
    engine on one device at ``MOE_TIE_F32_LAYERS`` (TF32 off), freed after
    its run."""
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("olmoe-1b-7b").with_(num_layers=MOE_TIE_F32_LAYERS,
                                          dtype="float32")
    _, prompts = serving_prompts(seed, cfg.vocab_size)
    t0 = time.perf_counter()
    out = _moe_serve_f32(cfg, seed, prompts, "olmoe f32 one device")
    out["first"] = out["first"].numpy()
    out["wall_s"] = time.perf_counter() - t0
    return out


def _moe_tie_rank(rank: int, world: int, seed: int):
    """One rank of phase 32, after phase 21's runs on the same rank
    process freed their engines: OLMoE-1B-7B uncut through
    ``Session(strategy=Strategy(expert_parallel=False)).serve(tp=)`` (the
    rank drawing only its shards from ``seed``) on phase 13's settings and
    requests on the mixed step, through ``_drive`` (launches counted from
    0 just before: ``_family_want``), its collectives and bytes by label;
    then the f32 check's runs at ``MOE_TIE_F32_LAYERS``: the rank's
    engine, and the same under ``_dropped_moe_out_sum``."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.core.strategy import Strategy
    torch.cuda.set_device(0)
    cfg = get_config("olmoe-1b-7b")
    _, prompts = serving_prompts(seed, cfg.vocab_size)
    t0 = time.perf_counter()
    eng = Session(cfg, strategy=Strategy(dtype=cfg.dtype, **MOE_TIE),
                  device="cuda", seed=seed).serve(
        tp=world, chunk_tokens=256, slots=4, max_len=1024, page_size=16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng._rank.counts.clear()
    eng._rank.bytes.clear()
    run = _drive(eng, prompts, MOE_TIE_NEW, f"olmoe tie mixed rank {rank}",
                 mixed=True)
    want = _family_want(eng, cfg)
    check(run["launches"] == want,
          f"[olmoe tie] rank {rank} launches {run['launches']} != {want}")
    run.update(rank=rank, build_s=build_s,
               weights_gb=sum(v.numel() * v.element_size()
                              for v in _leaves(eng.params)) / 1e9,
               w_up=list(eng.params["layers"]["moe"]["w_up"].shape),
               collectives=dict(eng._rank.counts),
               collective_bytes=dict(eng._rank.bytes))
    out = {"rank": rank, "bfloat16": run}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    _tp_rank_setup()
    cfg32 = cfg.with_(num_layers=MOE_TIE_F32_LAYERS, dtype="float32")
    out["float32"] = _moe_serve_f32(cfg32, seed, prompts,
                                    f"olmoe tie f32 rank {rank}", tp=world)
    with _dropped_moe_out_sum():
        out["defect"] = _moe_serve_f32(cfg32, seed, prompts,
                                       f"olmoe tie f32 defect rank {rank}",
                                       tp=world)
    for key in ("float32", "defect"):
        out[key]["first"] = out[key]["first"].numpy()
    return out


def phase_moe_tie_serve(ranks, one: dict, single: dict, ep: dict,
                        smi: str):
    """Phase 32: TP INSIDE EACH EXPERT, SERVING — OLMoE-1B-7B uncut (16
    layers, 64 experts top 8, d_ff 1024 an expert) at tp 2 with
    ``Strategy(expert_parallel=False)`` on phase 21's two rank processes
    (``_moe_tie_rank``): each rank 8/8 heads x 128, all 64 experts at 512
    of their d_ff and half the vocabulary, phase 13's six requests on the
    mixed step, 16 new tokens each. Checks on each rank: every request
    finishes with in-vocab tokens, launches as ``_family_want`` says, both
    ranks' streams equal, one ``moe_out`` and one ``attn_out`` sum a layer
    a program (and no ``mlp_out``), the ``moe_out`` bytes a program 1/k
    (k = 8) of phase 21's (``ep``: the same 256-row programs, the
    experts over "model"), the weights a rank within 1% of phase 21's.
    Reports tokens/s, step p50 with prefill and decode-only apart, peak
    memory a rank, collectives and bytes a program, and the share of
    tokens equal to phase 13's (``single``) and to phase 21's streams
    (information: bf16 sums in another order). Then the f32 check at full
    width cut to ``MOE_TIE_F32_LAYERS``: both ranks' streams equal the
    one-device engine's (``one``, run and freed before the ranks started)
    and their first logits within ``VLM_TP_LOGITS_TOL``; a run without
    the ``moe_out`` sum is outside it. Two ranks share one card's SMs and
    gloo stages each all-reduce through host memory: not tensor
    parallelism's speed."""
    from repro_torch.configs import get_config
    cfg = get_config("olmoe-1b-7b")
    layers, k = cfg.num_layers, cfg.experts_per_token
    note = ("two ranks share one card's SMs and gloo stages each "
            "all-reduce through host memory: not tensor parallelism's "
            "speed")
    out = {"note": note, "card": smi, "ranks": ranks,
           "one_device_f32": {k_: v for k_, v in one.items()
                              if k_ != "first"}}
    r0 = ranks[0]["bfloat16"]
    for r, epr in zip(ranks, ep["ranks"]):
        run, tag = r["bfloat16"], f"[olmoe tie bf16] rank {r['rank']}"
        e = epr["mixed"]
        check(run["streams"] == r0["streams"],
              f"{tag} streams differ from rank 0's")
        programs = run["program_runs"]
        c, b = run["collectives"], run["collective_bytes"]
        check(c.get("moe_out") == c.get("attn_out") == layers * programs
              and "mlp_out" not in c and "moe_gate.grad" not in c,
              f"{tag} collectives {c}: want one moe_out and one attn_out "
              f"a layer a program ({layers} x {programs})")
        check(run["w_up"] == [layers, cfg.num_experts, cfg.d_model,
                              cfg.d_ff // TP_DEGREE],
              f"{tag} w_up {run['w_up']}")
        per, ep_per = b["moe_out"] / programs, \
            e["collective_bytes"]["moe_out"] / e["program_runs"]
        check(per * k == ep_per,
              f"{tag} moe_out {per} B a program x {k} != phase 21's "
              f"{ep_per} B")
        w_ep = epr["weights_gb"]
        check(abs(run["weights_gb"] - w_ep) <= 0.01 * w_ep,
              f"{tag} {run['weights_gb']:.3f} GB of weights a rank, phase "
              f"21's {w_ep:.3f} GB")
        f32 = r["float32"]
        check(f32["launches"] == f32["want"],
              f"[olmoe tie f32] rank {r['rank']} launches {f32['launches']} "
              f"!= {f32['want']}")
        check(f32["streams"] == one["streams"],
              f"[olmoe tie f32] rank {r['rank']} streams {f32['streams']} != "
              f"the one-device f32 engine's {one['streams']}")
        err = float(np.abs(f32.pop("first") - one["first"]).max())
        bad = float(np.abs(r["defect"].pop("first") - one["first"]).max())
        check(err <= VLM_TP_LOGITS_TOL,
              f"[olmoe tie f32] rank {r['rank']} first logits {err:.3e} from "
              f"the one-device engine's (limit {VLM_TP_LOGITS_TOL})")
        check(bad > VLM_TP_LOGITS_TOL,
              f"[olmoe tie f32] the check passes a run without the moe_out "
              f"sum ({bad:.3e})")
        f32.update(first_logits_err=err, defect_first_logits_err=bad,
                   defect_streams_equal=r["defect"]["streams"]
                   == one["streams"])
        run["moe_out_bytes_a_program"] = per
        run["ep_moe_out_bytes_a_program"] = ep_per
    for name, streams in (("single", single["mixed"]["streams"]),
                          ("ep", ep["mixed"]["streams"])):
        r0[f"agree_with_{name}"] = sum(
            a == b for got, want in zip(r0["streams"], streams)
            for a, b in zip(got, want)) / r0["tokens"]
    programs = r0["program_runs"]
    per_program = {k_: round(v / programs, 2)
                   for k_, v in r0["collectives"].items()}
    mb = {k_: round(v / programs / 1e6, 3)
          for k_, v in r0["collective_bytes"].items()}
    log(_run_text("olmoe tie tp 2 bf16, rank 0", r0)
        + f"; w_up a rank {r0['w_up']}, {r0['weights_gb']:.3f} GB of weights "
        f"a rank (built in {r0['build_s']:.1f}s); peak memory a rank "
        f"{[round(x['bfloat16']['peak_mem_gb'], 2) for x in ranks]} GB; "
        f"collectives a program {per_program}, MB a program {mb} (moe_out "
        f"{r0['moe_out_bytes_a_program']:.0f} B, phase 21's "
        f"{r0['ep_moe_out_bytes_a_program']:.0f} B); "
        f"{r0['agree_with_single']:.1%} of tokens equal to phase 13's, "
        f"{r0['agree_with_ep']:.1%} to phase 21's streams (information) — "
        f"{note}")
    f = ranks[0]["float32"]
    log(f"[olmoe tie tp 2 f32] full width, {MOE_TIE_F32_LAYERS} layers: both "
        f"ranks' streams equal the one-device engine's over "
        f"{len(one['streams'])} requests (one device {one['wall_s']:.1f}s); "
        f"first logits max abs err "
        f"{max(r['float32']['first_logits_err'] for r in ranks):.3e} (limit "
        f"{VLM_TP_LOGITS_TOL}); without the moe_out sum "
        f"{min(r['float32']['defect_first_logits_err'] for r in ranks):.3e} "
        f"(streams equal: {f['defect_streams_equal']}); launches a rank "
        f"{f['launches']} on {smi}")
    out["bfloat16"], out["float32"] = r0, f
    return out


def _moe_grad_leaf(key: str) -> bool:
    return key.rsplit("/", 1)[-1] == "router"


#: where phase 24's and phase 33's one-device f32 steps, made before
#: phase 24's ranks start, leave their results for them (one .npy a leaf,
#: read by memory map; removed once phase 33 is done)
F32_REF_DIR = ROOT / "chip_tmp"


def _ref_path(name: str, prefix: str, key: str) -> Path:
    return F32_REF_DIR / name / f"{prefix}--{key.replace('/', '--')}.npy"


def _one_device_reference(name: str, cfg, strategy, seed: int, batch,
                          keep, prepare=None) -> dict:
    """A sharded phase's one-device f32 step (TF32 off), run in this
    process before phase 24's ranks start: ``cfg`` drawn from ``seed`` +
    1 (then ``prepare(params)``, where given), one step of ``strategy``
    on ``batch`` (numpy arrays); its new params and the gradients before
    clipping of the keys ``keep`` accepts go to ``F32_REF_DIR / name``.
    Returns its metrics, step time, peak memory and write time."""
    import shutil
    from repro_torch.params import init_params
    from repro_torch.train import step as tstep
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = init_params(cfg, device="cuda", seed=seed + 1)
    if prepare is not None:
        prepare(params)
    step = tstep.make_train_step(cfg, strategy, lr=SHARDED_F32_LR)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _captured_grads(keep) as got:
        new, opt, m = step(params, tstep.init_opt_state(params, strategy),
                           {k: torch.from_numpy(v).cuda()
                            for k, v in batch.items()})
    torch.cuda.synchronize()
    out = {"step_s": time.perf_counter() - t0,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    shutil.rmtree(F32_REF_DIR / name, ignore_errors=True)
    (F32_REF_DIR / name).mkdir(parents=True)
    t0 = time.perf_counter()
    for prefix, tree in (("param", flatten(new)), ("grad", got)):
        for key, v in tree.items():
            np.save(_ref_path(name, prefix, key), v.detach().cpu().numpy())
    out["write_s"] = time.perf_counter() - t0
    del params, new, opt, step, m, got
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _reference_block(name: str, prefix: str, key: str, spec, axes, coord):
    """This rank's block under ``spec`` of leaf ``key`` of the one-device
    step ``name`` (``_one_device_reference``), read by memory map."""
    from repro_torch.core import tp
    full = np.load(_ref_path(name, prefix, key), mmap_mode="c")
    return tp.shard_leaf(torch.from_numpy(full), spec, axes, coord).clone()


def _moe_f32_reference(seed: int, batch) -> dict:
    """Phase 33's one-device f32 step (AdamW) at full width,
    ``MOE_SHARDED_F32_LAYERS`` layer, on ``batch``, made before phase 24's
    ranks start (``_one_device_reference``: its params and the router's
    gradient before clipping under ``F32_REF_DIR / "moe"``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.strategy import Strategy
    cfg = get_config("olmoe-1b-7b").with_(num_layers=MOE_SHARDED_F32_LAYERS,
                                          dtype="float32")
    return _one_device_reference("moe", cfg, Strategy(dtype="float32",
                                                      remat=False),
                                 seed, batch, _moe_grad_leaf)


#: phase 33's f32 defects: name -> (Strategy keywords, the context that
#: breaks the run), each at (2, 2) under SP with TP inside each expert
MOE_SHARDED_DEFECTS = {
    "tie sp, moe_out sum dropped": (MOE_F32_SP, _dropped_moe_out_sum),
    "tie sp, gate entry dropped": (MOE_F32_SP, _dropped_gate_entry)}


def _moe_sharded_f32_rank(mesh, seed: int, ref: dict):
    """Phase 33's f32 check on this rank (TF32 off): each of
    ``MOE_F32_RUNS`` and ``MOE_SHARDED_DEFECTS`` for one step on the
    rank's shards, on ``ref["batch"]``; the run's worst param error of the
    reference test's 5e-4 and the router gradient's of ``VLM_GRAD_ATOL`` +
    ``VLM_GRAD_RTOL`` against the one-device step's (its files
    ``F32_REF_DIR / "moe"``, its metrics ``ref["one_device"]``), its
    loss's distance and its step's seconds."""
    from repro_torch.configs import get_config
    from repro_torch.core import tp
    from repro_torch.core.strategy import Strategy, mesh_axes
    from repro_torch.params import full_shapes, init_params
    from repro_torch.train import step as tstep
    from repro_torch.tree import flatten
    _tp_rank_setup()
    cfg = get_config("olmoe-1b-7b").with_(num_layers=MOE_SHARDED_F32_LAYERS,
                                          dtype="float32")
    batch = {k: torch.from_numpy(v).cuda() for k, v in ref["batch"].items()}
    shapes = full_shapes(cfg)
    axes, coord = mesh_axes(mesh), tp.coordinate(mesh)
    out = {"one_device": dict(ref["one_device"])}
    runs = {name: (kw, None) for name, kw in MOE_F32_RUNS.items()}
    runs.update(MOE_SHARDED_DEFECTS)
    for name, (kw, defect) in runs.items():
        st = Strategy(dtype="float32", **kw)
        rank = tp.Rank.of(mesh, cfg, st, shapes)
        params = init_params(cfg, device="cuda", seed=seed + 1,
                             shard=(st, mesh))
        step = tstep.make_train_step(cfg, st, lr=SHARDED_F32_LR)
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (defect or nullcontext)(), tp.active(rank), \
                _captured_grads(_moe_grad_leaf) as got:
            opt = tstep.init_opt_state(params, st)
            new, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        worst, worst_key = 0.0, None
        for key, block in flatten(new).items():
            want = _reference_block("moe", "param", key,
                                    rank.leaves[key].spec, axes, coord)
            e = _chunked_excess(block.detach(), want, SHARDED_PARAM_TOL,
                                SHARDED_PARAM_TOL)
            if e > worst:
                worst, worst_key = e, key
        gworst, gkey = 0.0, None
        for key, g in got.items():
            want = _reference_block("moe", "grad", key,
                                    rank.leaves[key].update, axes, coord)
            e = worst_excess(g, want, VLM_GRAD_ATOL, VLM_GRAD_RTOL)
            if e > gworst:
                gworst, gkey = e, key
        check(gkey is not None, f"[moe sharded train f32 {name}] no router "
                                f"gradient captured")
        out[name] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "step_s": step_s,
                     "param_error_of_limit": worst, "worst_leaf": worst_key,
                     "grad_error_of_limit": gworst, "worst_grad_leaf": gkey,
                     "loss_err": abs(float(m["loss"])
                                     - ref["one_device"]["loss"])}
        del params, new, opt, step, m, got
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _moe_sharded_rank(rank: int, mesh, seed: int, f32_ref: dict):
    """One rank of phase 33, after phase 31 on the same rank processes:
    the two bf16 runs of ``MOE_SHARDED_RUNS`` (a Trainer drawing only its
    shards, the token dataset from ``seed``), then the f32 check
    (``_moe_sharded_f32_rank``)."""
    from repro_torch.configs import get_config
    cfg = get_config("olmoe-1b-7b").with_(num_layers=MOE_SHARDED_LAYERS)
    out = {}
    t0 = time.perf_counter()
    for name in MOE_SHARDED_RUNS:
        out[name] = _sharded_bf16_run(mesh, cfg, name, seed,
                                      steps=MOE_SHARDED_STEPS,
                                      runs=MOE_SHARDED_RUNS)
        _rank_log(rank, f"{name} done at {time.perf_counter() - t0:.1f}s: "
                        f"steps {[round(x, 3) for x in out[name]['step_s']]}"
                        f" s, peak {out[name]['peak_mem_gb']:.2f} GB",
                  "moe sharded train")
    out["f32"] = _moe_sharded_f32_rank(mesh, seed, f32_ref)
    _rank_log(rank, f"f32 check done at {time.perf_counter() - t0:.1f}s: "
                    + ", ".join(f"{k} {v['step_s']:.1f}s"
                                for k, v in out["f32"].items()
                                if k != "one_device"), "moe sharded train")
    return out


def _moe_sharded_flops() -> dict:
    """Phase 33's step as one rank of its (2, 2) mesh, traced on meta
    (``Session.dryrun`` as the card's branch, no device) for each run of
    ``MOE_SHARDED_RUNS``: its FLOPs a rank, and of them the expert
    products' (three a layer over each data rank's ``C / batch_dp`` slots
    of its experts, forward, remat recompute and two backward products
    each), with what the whole capacity C would cost a rank."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.strategy import Strategy
    from repro_torch.models.moe import capacity
    cfg = get_config("olmoe-1b-7b").with_(num_layers=MOE_SHARDED_LAYERS)
    dp, tp = SHARDED_MESH
    shape = ShapeConfig("phase33", SHARDED_SEQ, SHARDED_BATCH, "train")
    cap = capacity(SHARDED_SEQ * SHARDED_BATCH, cfg)
    # a rank's experts x its d_ff of each: E / tp whole, or E at d_ff / tp
    expert = 3 * 2 * (cfg.num_experts // tp) * cfg.d_model * cfg.d_ff \
        * 4 * cfg.num_layers
    out = {}
    for name, kw in MOE_SHARDED_RUNS.items():
        rec = Session(cfg, strategy=Strategy(dtype=cfg.dtype, **kw),
                      device="cuda", mesh={"data": dp, "model": tp}).dryrun(
            shape)
        out[name] = {"flops": rec["roofline"]["hlo_flops"]
                     / rec["roofline"]["chips"],
                     "expert_flops": expert * -(-cap // dp),
                     "whole_capacity_expert_flops": expert * cap}
    return out


def phase_moe_train_sharded(ranks, smi: str):
    """Phase 33: MoE TRAINING ON A MESH, on phase 24's four rank
    processes after phase 31 (``_moe_sharded_rank``): OLMoE-1B-7B at full
    width (16/16 heads x 128, 64 experts top 8 of d_ff 1024, vocab 50,304)
    cut to ``MOE_SHARDED_LAYERS`` layers, dp 2 x tp 2, AdamW with remat,
    ``MOE_SHARDED_STEPS`` steps of 2 x 2048 tokens (the token dataset)
    in each of two runs that differ in the MoE's layout alone: the experts
    over "model" (``ep zero1``, the default strategy: 32 whole experts a
    rank) and TP inside each expert (``tie zero1``: all 64 at 512 of
    their d_ff). Checks (``_sharded_checks``): flash once a layer a step
    and once more for the remat recompute (a data rank's (1, 2048, 2048,
    8, 8, 128)), the other kernels never; the same metrics on every rank,
    the data replicas' blocks equal bit for bit. Then the f32 check at
    ``MOE_SHARDED_F32_LAYERS`` layer (``MOE_F32_RUNS``: TP inside each
    expert with SP) against the one-device step made before the ranks
    started, params within 5e-4 and the router's gradient before clipping
    within atol 1e-6 + rtol 1e-3, and two defects outside those bounds
    (``MOE_SHARDED_DEFECTS``): no ``moe_out`` sum, and the gates without
    their ``enter``."""
    import shutil
    want = {"flash_attention": MOE_SHARDED_STEPS * 2 * MOE_SHARDED_LAYERS,
            "fused_mlp": 0, "paged_attention": 0, "ssd_scan": 0}
    runs = [dict(r.pop("moe"), rank=r["rank"], coord=r["coord"])
            for r in ranks]
    shutil.rmtree(F32_REF_DIR, ignore_errors=True)
    out = _sharded_checks(
        runs, f"OLMoE-1B-7B {MOE_SHARDED_LAYERS} layers",
        f"OLMoE-1B-7B {MOE_SHARDED_F32_LAYERS} layer", want,
        MOE_SHARDED_DEFECTS, smi, "moe sharded train",
        steps=MOE_SHARDED_STEPS, runs_by_name=MOE_SHARDED_RUNS,
        f32_runs=MOE_F32_RUNS)
    # a moe_out sum's bytes: the (T, d) output against the (T k, d) slots
    # (the remat recompute stops at the last saved tensor, before the
    # output's sum inside each expert: fewer sums a step there)
    each = {name: runs[0][name]["step_bytes"]["moe_out"]
            / runs[0][name]["step_collectives"]["moe_out"]
            for name in MOE_SHARDED_RUNS}
    ep, tie = each["ep zero1"], each["tie zero1"]
    out["moe_out_bytes_a_sum"] = each
    out["flops_a_rank"] = _moe_sharded_flops()
    flops = out["flops_a_rank"]
    log(f"[moe sharded train] FLOPs a rank (a dry-run of the step on meta): "
        + "; ".join(f"{n} {f['flops']:.4e}, of which the expert products "
                    f"{f['expert_flops']:.4e} (each data rank's C / 2 slots;"
                    f" the whole capacity's {f['whole_capacity_expert_flops']:.4e})"
                    for n, f in flops.items()))
    log(f"[moe sharded train] a moe_out sum's bytes with TP inside each "
        f"expert {tie / 1e6:.2f} MB, with the experts over 'model' "
        f"{ep / 1e6:.2f} MB ({tie / ep:.4f}x; sums a step "
        f"{ {n: runs[0][n]['step_collectives']['moe_out'] for n in each} })")
    out["ranks"] = runs
    return out


# ---------------------------------------------------------- phases 34-35

#: the planner's shapes: one 256-token chunk of phase 5's mixed step (its
#: serving), phase 6's 1 x 4096 and phase 24's 2 x 2048 (training)
PLAN_SERVE_SHAPE = ("chunk_256", 256, 1, "prefill")
PLAN_TRAIN_SHAPE = ("train_1x4096", 4096, 1, "train")
PLAN_SHARDED_SHAPE = ("train_2x2048", SHARDED_SEQ, SHARDED_BATCH, "train")
PLAN_TRAIN_STEPS = 2
#: the degrees each plan must come out with on the H100 entry
PLAN_WANT = {"serve": "dp1 tp1 pp1 m1", "train": "dp1 tp1 pp1 m1",
             "tp serve": "dp1 tp2 pp1 m1 sp",
             "sharded": "dp2 tp2 pp1 m1 sp"}
PLAN_TIMEOUT_S = 300.0


def _plan_for(cfg, shape, chips: int, method: str, what: str):
    """The planner's plan for ``cfg`` at ``shape`` (a ShapeConfig's
    fields) on ``chips`` H100s by ``method``; it must be
    ``PLAN_WANT[what]``."""
    from repro_torch.api import plan
    from repro_torch.configs.base import ShapeConfig
    p = plan(cfg, ShapeConfig(*shape), chips, method=method)
    check(p.summary(compact=True) == PLAN_WANT[what],
          f"[plan {what}] {cfg.name} at {shape} on {chips} chip(s) by "
          f"{method!r}: {p.summary()}, not {PLAN_WANT[what]}")
    return p


def _cost_model_mfu(cfg, tokens: int, train: bool, seconds: float,
                    chips: int) -> float:
    """The cost model's own MFU of a step measured at ``seconds``: its
    model FLOPs (6 or 2 x ``active_param_count()`` x tokens,
    ``core/costmodel.py::estimate``) over ``chips`` x 989 TFLOP/s."""
    n = (6.0 if train else 2.0) * cfg.active_param_count() * tokens
    return n / (chips * PEAK_FLOPS["bfloat16"] * seconds)


def _plan_line(tag: str, row: dict, summary: str, measured_s: float,
               measured_mfu: float, note: str = "") -> dict:
    """The plan's estimate beside the measured step: a record, logged."""
    out = {"plan": row, "summary": summary, "estimate_s": row["cost"],
           "estimate_mfu": row["mfu"], "measured_s": measured_s,
           "measured_mfu_cost_model": measured_mfu,
           "measured_over_estimate": measured_s / row["cost"]}
    log(f"[{tag}] {summary}: estimate {row['cost'] * 1e3:.3f} ms at "
        f"MFU {row['mfu']:.2%}; measured {measured_s * 1e3:.2f} ms at "
        f"{measured_mfu:.2%} MFU by the cost model's own FLOPs: "
        f"{out['measured_over_estimate']:.1f}x the estimate{note}")
    return out


def _steps_with_prefill(eng):
    """Step ``eng`` until idle: each step's seconds and whether it took
    prefill rows."""
    step_s, prefill = [], []
    while eng.busy():
        s0 = time.perf_counter()
        chunk0 = eng.stats["prefill_chunk_tokens"]
        eng.step()
        step_s.append(time.perf_counter() - s0)
        prefill.append(eng.stats["prefill_chunk_tokens"] > chunk0)
    torch.cuda.synchronize()
    return np.asarray(step_s), np.asarray(prefill)


def phase_plan_serve(session, main_run: dict, prompts, seed: int):
    """Phase 34, serving: the planner's one-chip plan for phase 5's
    model at ``PLAN_SERVE_SHAPE`` (H100), ``Session.from_plan`` on it
    with phase 5's weights set through the params setter, phase 5's
    engine settings and six requests: streams bit-equal to phase 5's,
    paged attention and the fused MLP once a layer a program; the plan's
    estimate beside the measured p50 of the steps with prefill rows."""
    from repro_torch import kernels
    from repro_torch.api import Session
    cfg = session.cfg
    p = _plan_for(cfg, PLAN_SERVE_SHAPE, 1, "exhaustive", "serve")
    planned = Session.from_plan(cfg, p, device="cuda", seed=seed)
    planned.params = session.params
    check(planned.mesh is None and planned.plan is p,
          "[plan serve] a one-chip plan's session has no mesh")
    eng = planned.serve(slots=4, max_len=1024, page_size=16,
                        chunk_tokens=256)
    for rid, prompt in enumerate(prompts):
        eng.submit(rid, prompt, max_new=main_run["max_new"])
    kernels.reset_launches()
    t0 = time.perf_counter()
    step_s, prefill = _steps_with_prefill(eng)
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    res = eng.results()
    streams = [list(res[r].out) for r in range(len(prompts))]
    check(streams == main_run["streams"],
          "[plan serve] streams differ from phase 5's")
    want = _want_launches(eng, cfg.num_layers)
    check(counts == want, f"[plan serve] launches {counts} != {want}")
    p50 = float(np.percentile(step_s[prefill], 50))
    tokens = sum(len(x) for x in streams)
    out = {"launches": counts, "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "step_p50_ms": float(np.percentile(step_s, 50)) * 1e3,
           "streams_equal_phase_5": True}
    out.update(_plan_line(
        "plan serve", p.row(), p.summary(), p50,
        _cost_model_mfu(cfg, 256, False, p50, 1),
        f" (the p50 of {int(prefill.sum())} steps with prefill rows; "
        f"{out['tokens_per_s']:.2f} tokens/s; streams = phase 5's)"))
    out["plan"] = p.row()
    out["strategy"] = repr(planned.strategy)
    del eng, planned
    return out


def phase_plan_train(seed: int, phase6: dict):
    """Phase 34, training: the three searches' one-chip plans for phase
    6's model and shape (each must be dp1 tp1 pp1 m1), and phase 6's run
    (``_train_run``, no profile) for ``PLAN_TRAIN_STEPS`` steps through
    ``Session.from_plan`` on the first: flash launched as phase 6
    launches it; its strategy agrees with phase 6's but for its name,
    so its losses and grad norms equal phase 6's first steps bit for
    bit; the plan's estimate beside the measured p50."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.core.strategy import Strategy
    cfg = get_config("qwen3-14b").with_(num_layers=phase6["layers"])
    plans = {m: _plan_for(cfg, PLAN_TRAIN_SHAPE, 1, m, "train")
             for m in ("exhaustive", "dp", "mcmc")}
    p = plans["exhaustive"]
    session = Session.from_plan(cfg, p, device="cuda", seed=seed)
    same = session.strategy.with_(name="megatron") == Strategy(
        dtype=cfg.dtype)
    check(same, f"[plan train] {session.strategy} is not phase 6's "
                f"strategy but for its name")
    run = _train_run(cfg, seed, PLAN_TRAIN_STEPS, PLAN_TRAIN_SHAPE[1],
                     session=session, profile=False)
    del session
    for key in ("losses", "grad_norms"):
        check(run[key] == phase6[key][:PLAN_TRAIN_STEPS],
              f"[plan train] {key} {run[key]} != phase 6's "
              f"{phase6[key][:PLAN_TRAIN_STEPS]}")
    out = {"run": run, "launches": run["launches"],
           "plans": {m: q.row() for m, q in plans.items()}}
    out.update(_plan_line(
        "plan train", p.row(), p.summary(), run["step_p50_s"],
        _cost_model_mfu(cfg, PLAN_TRAIN_SHAPE[1], True, run["step_p50_s"],
                        1),
        f" (the script's own count: {run['model_flops_share_of_989T']:.2%}"
        f" of 989 TFLOP/s; the searches: "
        + "; ".join(f"{m} {q.summary(compact=True)}, "
                    f"{q.evaluations} evaluations"
                    for m, q in plans.items())
        + "; losses and grad norms = phase 6's)"))
    return out


def _plan_tp_rank(rank: int, world: int, seed: int, prompts, max_new: int):
    """One rank of phase 35's serving: the "dp" search's plan for phase
    19's model at ``PLAN_SERVE_SHAPE`` on ``world`` chips,
    ``Session.from_plan`` (its rank blocks drawn from ``seed``, as phase
    19's), ``serve()`` at the plan's degrees with phase 19's settings
    and prompts: streams, launches, steps."""
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    torch.cuda.set_device(0)
    cfg = get_config("qwen3-14b").with_(num_layers=TP_SERVE_LAYERS)
    p = _plan_for(cfg, PLAN_SERVE_SHAPE, world, "dp", "tp serve")
    session = Session.from_plan(cfg, p, device="cuda", seed=seed)
    eng = session.serve(slots=4, max_len=1024, page_size=16,
                        chunk_tokens=256)
    for rid, prompt in enumerate(prompts):
        eng.submit(rid, prompt, max_new=max_new)
    kernels.reset_launches()
    eng._rank.counts.clear()
    t0 = time.perf_counter()
    step_s, prefill = _steps_with_prefill(eng)
    wall = time.perf_counter() - t0
    res = eng.results()
    out = {"rank": rank, "plan": p.row(), "summary": p.summary(),
           "strategy": repr(session.strategy), "tp": eng.tp,
           "own_mesh": eng.mesh is session.mesh, "wall_s": wall,
           "launches": kernels.launches(),
           "want_launches": _want_launches(eng, cfg.num_layers),
           "collectives": dict(eng._rank.counts),
           "prefill_step_p50_s": float(np.percentile(step_s[prefill], 50)),
           "step_p50_ms": float(np.percentile(step_s, 50)) * 1e3,
           "streams": [list(res[r].out) for r in range(len(prompts))]}
    del eng, session
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_plan_tp_serve(seed: int, max_new: int = 16):
    """Phase 35, serving: ``_plan_tp_rank`` on phase 19's two rank
    processes; checked against phase 19 by ``phase_plan_ranks``."""
    from repro_torch.configs import get_config
    _, prompts = serving_prompts(seed, get_config("qwen3-14b").vocab_size)
    prompts = [np.asarray(p, np.int32) for p in prompts]
    return (yield RankJob(_plan_tp_rank, (seed, prompts, max_new),
                          PLAN_TIMEOUT_S, "plan tp serve"))


def _plan_sharded_rank(rank: int, world: int, seed: int):
    """One rank of phase 35's training: the "dp" search's plan for phase
    24's model at ``PLAN_SHARDED_SHAPE`` on ``world`` chips,
    ``Session.from_plan``, ``train()`` at the plan's degrees on the
    plan's mesh for phase 24's steps of its token batches (its blocks
    drawn from ``seed``, as phase 24's): history, launches, collectives,
    step seconds."""
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.core.strategy import mesh_axes
    from repro_torch.train.trainer import TrainConfig
    _tp_rank_setup()
    cfg = get_config("qwen3-14b").with_(num_layers=SHARDED_LAYERS)
    p = _plan_for(cfg, PLAN_SHARDED_SHAPE, world, "dp", "sharded")
    torch.cuda.reset_peak_memory_stats()
    session = Session.from_plan(cfg, p, device="cuda", seed=seed)
    trainer = session.train(TrainConfig(steps=SHARDED_STEPS, lr=3e-4,
                                        log_every=1, seed=seed),
                            global_batch=SHARDED_BATCH, seq_len=SHARDED_SEQ)
    kernels.reset_launches()
    trainer.rank.counts.clear()
    step_s = []
    for _ in range(SHARDED_STEPS):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        trainer.run(1)                      # ends in float(loss): a sync
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s0)
    out = {"rank": rank, "plan": p.row(), "summary": p.summary(),
           "strategy": session.strategy, "axes": mesh_axes(session.mesh),
           "coord": {n: int(session.mesh[n].get_local_rank())
                     for n in session.mesh.mesh_dim_names},
           "step_s": step_s, "launches": kernels.launches(),
           "collectives": dict(trainer.rank.counts),
           "history": [{k: h[k] for k in ("loss", "aux_loss", "grad_norm")}
                       for h in trainer.history],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del trainer, session
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_plan_sharded(seed: int):
    """Phase 35, training: ``_plan_sharded_rank`` on phase 24's four rank
    processes; checked against phase 24 by ``phase_plan_ranks``."""
    return (yield RankJob(_plan_sharded_rank, (seed,), PLAN_TIMEOUT_S,
                          "plan sharded train",
                          world=math.prod(SHARDED_MESH)))


def phase_plan_ranks(tp_ranks, tp: dict, sharded_ranks, sharded: dict,
                     smi: str):
    """Phase 35's checks and report. Serving: the plan is dp1 tp2 sp on
    every rank, the engine tp 2 on the session's own mesh, launches as
    phase 19's engine launches them, and the bf16 streams equal phase
    19's mixed run's (same call). Training: the plan is dp2 tp2 sp on a
    ("data", "model") = (2, 2) mesh; its strategy agrees with phase 24's
    sequence-parallel run but for its name, so each rank's loss and grad
    norm equal that run's bit for bit; flash launched as phase 24's;
    both strategies printed. Each plan's estimate beside its measured
    step (two or four ranks share one card over gloo: the ratio
    describes that setup, not the cost model)."""
    from repro_torch.configs import get_config
    from repro_torch.core.strategy import Strategy
    out = {"tp_ranks": tp_ranks, "sharded_ranks": sharded_ranks}
    for r in tp_ranks:
        check(r["tp"] == 2 and r["own_mesh"],
              f"[plan tp serve] rank {r['rank']}: tp {r['tp']}, own mesh "
              f"{r['own_mesh']}")
        check(r["launches"] == r["want_launches"],
              f"[plan tp serve] rank {r['rank']} launches {r['launches']} "
              f"!= {r['want_launches']}")
        check(r["streams"] == tp["mixed"]["streams"],
              f"[plan tp serve] rank {r['rank']} streams differ from phase "
              f"19's mixed run")
    r0 = tp_ranks[0]
    cfg = get_config("qwen3-14b").with_(num_layers=TP_SERVE_LAYERS)
    out["serve"] = _plan_line(
        "plan tp serve", r0["plan"], r0["summary"], r0["prefill_step_p50_s"],
        _cost_model_mfu(cfg, 256, False, r0["prefill_step_p50_s"], 2),
        f" (rank 0's steps with prefill rows; strategy {r0['strategy']}; "
        f"streams = phase 19's on both ranks; collectives a rank "
        f"{r0['collectives']} — two ranks share one card over gloo: not "
        f"the cost model's machine)")
    phase24 = Strategy(dtype="bfloat16", **SHARDED_RUNS["sp"])
    by_rank = {r["rank"]: r for r in sharded["ranks"]}
    for r in sharded_ranks:
        check(r["axes"] == {"data": 2, "model": 2},
              f"[plan sharded] rank {r['rank']} mesh {r['axes']}")
        check(r["strategy"].with_(name=phase24.name) == phase24,
              f"[plan sharded] {r['strategy']} is not phase 24's SP run's "
              f"{phase24} but for its name")
        ref = by_rank[r["rank"]]
        check(r["coord"] == ref["coord"],
              f"[plan sharded] rank {r['rank']} at {r['coord']}, phase "
              f"24's at {ref['coord']}")
        check(r["history"] == ref["sp"]["history"],
              f"[plan sharded] rank {r['rank']} {r['history']} != phase "
              f"24's SP run's {ref['sp']['history']}")
        check(r["launches"] == ref["sp"]["launches"],
              f"[plan sharded] rank {r['rank']} launches {r['launches']} "
              f"!= phase 24's {ref['sp']['launches']}")
    s0 = sharded_ranks[0]
    p50 = float(np.percentile(s0["step_s"], 50))
    cfg = get_config("qwen3-14b").with_(num_layers=SHARDED_LAYERS)
    out["sharded"] = _plan_line(
        "plan sharded", s0["plan"], s0["summary"], p50,
        _cost_model_mfu(cfg, SHARDED_BATCH * SHARDED_SEQ, True, p50, 4),
        f" (rank 0; its strategy {s0['strategy']}, phase 24's SP run's "
        f"{phase24}: loss and grad norm equal on every rank, "
        f"{s0['history']}; peak a rank "
        f"{[round(r['peak_mem_gb'], 2) for r in sharded_ranks]} GB; four "
        f"ranks share one card over gloo: the ratio describes that setup, "
        f"not the cost model; {smi})")
    for r in sharded_ranks:
        r["strategy"] = repr(r["strategy"])
    return out


# ---------------------------------------------------------- phases 37-38

#: phase 37: Llama-3.2-Vision-90B at full width cut to phase 31's one
#: group (``VLM_SHARDED_LAYERS``: 4 self and 1 cross layer, the unused
#: trailing one; 7.235 B params) behind the dp 2 x tp 2 ``ReplicaRouter``
#: on phase 24's four rank processes (``Session.serve(dp=2, tp=2)``, each
#: rank drawing only its shards), 4 slots x 1024 a replica, phase 17's six
#: requests and images, ``ROUTED_VLM_NEW`` new tokens each; its f32 check
#: at ``VLM_F32_CUT`` on phase 30's requests, ``VLM_TP_F32_NEW`` tokens
#: each, against a dp 2 router of the same replicas unsharded on one
#: device (the same homes, so each replica's decode batch is the same)
ROUTED_VLM_NEW = 8
ROUTED_VLM_TIMEOUT_S = 300.0
#: phase 38: the ("pod", "data", "model") meshes the tiny f32 config
#: serves on, and Qwen3-14B's (phase 19's ``TP_SERVE_LAYERS`` layers)
POD_MESHES = ((2, 1, 2), (1, 2, 2))
POD_MESH = (2, 1, 2)
POD_TIMEOUT_S = 300.0


def _rank_router_run(router, prompts, max_new: int, tag: str, *,
                     images=None):
    """Submit ``prompts`` to a router over rank processes (each with its
    images, where given), zero the launch counts and the local engine's
    collectives, step until no replica is busy and read them: every
    request of every replica finishes with ``max_new`` in-vocab tokens.
    Steps where the local replica had work are timed (a step of the
    local engine), prefill steps and decode-only steps apart. Returns the
    run's record: the union of the streams, the local replica's stats and
    launches."""
    from repro_torch import kernels
    eng = router.engines[0]
    homes = [router.submit(rid, p, max_new=max_new,
                           images=None if images is None else images[rid])
             for rid, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    eng._rank.counts.clear()
    eng._rank.bytes.clear()
    step_s, prefill_step = [], []
    t0 = time.perf_counter()
    while router.busy():
        if not eng.busy():
            continue
        s0 = time.perf_counter()
        before = eng.stats["prefills"] + eng.stats["prefill_chunk_tokens"]
        router.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s0)
        prefill_step.append(eng.stats["prefills"]
                            + eng.stats["prefill_chunk_tokens"] > before)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    res = router.results()
    cfg = router.cfg
    for rid in range(len(prompts)):
        r = res[rid]
        check(r.done and len(r.out) == max_new
              and all(0 <= t < cfg.vocab_size for t in r.out),
              f"[{tag}] request {rid} finished={r.done} with {len(r.out)} "
              f"tokens")
    st = eng.stats
    step_ms = np.asarray(step_s) * 1e3
    with_pf = np.asarray(prefill_step, dtype=bool)
    tokens = sum(len(res[r].out) for r in res)
    return {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "steps": len(step_s), "homes": homes,
            "requests_a_replica": [homes.count(r) for r in range(router.dp)],
            "row": router.row, "rows": router.meshes,
            "step_p50_ms": float(np.percentile(step_ms, 50)),
            "prefill_step_p50_ms": float(np.percentile(step_ms[with_pf], 50))
            if with_pf.any() else None,
            "decode_only_step_p50_ms": float(
                np.percentile(step_ms[~with_pf], 50))
            if (~with_pf).any() else None,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "prefills": st["prefills"], "decode_steps": st["decode_steps"],
            "mixed_steps": st["mixed_steps"],
            "decode_traces": st["decode_traces"], "launches": counts,
            "collectives": dict(eng._rank.counts),
            "collective_bytes": dict(eng._rank.bytes),
            "streams": [list(res[rid].out) for rid in range(len(prompts))]}


def _vlm_router_f32(seed: int, tag: str, tp=None):
    """Phase 37's f32 check on a dp 2 router at ``VLM_F32_CUT`` (TF32
    off), weights from ``seed`` with both gates open: on one device (both
    replicas on cuda:0, sharing the weights), or (``tp``) on this rank's
    shards through ``Session.serve(dp=2, tp=tp)``; phase 30's requests,
    ``VLM_TP_F32_NEW`` tokens each. Returns the streams, the homes, the
    launches (counted from 0 just before) and ``_vlm_want``'s."""
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama-3.2-vision-90b").with_(dtype="float32",
                                                   **VLM_F32_CUT)
    prompts, images = _vlm_requests(seed, cfg)
    kw = dict(slots=4, max_len=1024)
    session = Session(cfg, device="cuda", seed=seed)
    router = session.serve(dp=2, tp=tp, **kw) if tp is not None else \
        session.serve(dp=2, devices=["cuda:0"] * 2, **kw)
    for e in router.engines:
        _open_gates(e.params)
    homes = [router.submit(rid, p, max_new=VLM_TP_F32_NEW, images=images[rid])
             for rid, p in enumerate(prompts)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = router.run()
    torch.cuda.synchronize()
    out = {"wall_s": time.perf_counter() - t0,
           "streams": [list(res[r].out) for r in range(len(prompts))],
           "done": all(res[r].done for r in res), "homes": homes,
           "launches": kernels.launches(),
           "want": _vlm_want(cfg, sum(e.stats["prefills"]
                                      for e in router.engines),
                             sum(e.stats["decode_steps"]
                                 for e in router.engines))}
    check(out["done"], f"[{tag}] unfinished requests")
    del router, session
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _vlm_router_rank(rank: int, world: int, seed: int):
    """One rank of phase 37: the bf16 run of Llama-3.2-Vision-90B's one
    group behind ``Session.serve(dp=2, tp=2)`` (``wo`` and ``w_down`` at
    the uncut model's init scale and the gates open, as phases 17 and 30
    serve it), then the f32 check's run (``_vlm_router_f32``)."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    _tp_rank_setup()
    full = get_config("llama-3.2-vision-90b")
    cfg = full.with_(num_layers=VLM_SHARDED_LAYERS)
    prompts, images = _vlm_requests(seed, cfg)
    t0 = time.perf_counter()
    router = Session(cfg, device="cuda", seed=seed).serve(
        dp=2, tp=world // 2, slots=4, max_len=1024)
    eng = router.engines[0]
    _uncut_init_scales(_open_gates(eng.params), cfg, full.num_layers)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    run = _rank_router_run(router, prompts, ROUTED_VLM_NEW,
                           f"vlm router bf16 rank {rank}", images=images)
    run.update(rank=rank, build_s=build_s,
               heads=[eng._rank.heads, eng._rank.kv_heads],
               weights_gb=sum(v.numel() * v.element_size()
                              for v in _leaves(eng.params)) / 1e9,
               want=_vlm_want(cfg, run["prefills"], run["decode_steps"]),
               prefill_lens=sorted(eng._prefill_lens))
    out = {"rank": rank, "bfloat16": run}
    del router, eng
    gc.collect()
    torch.cuda.empty_cache()
    out["float32"] = _vlm_router_f32(seed, f"vlm router f32 rank {rank}",
                                     tp=world // 2)
    return out


def phase_vlm_router(seed: int, smi: str):
    """Phase 37: THE VLM BEHIND THE DP x TP ROUTER — Llama-3.2-Vision-90B
    at full width (64/8 heads x 128, d 8192, d_ff 28672, vocab 128,256,
    1601 image tokens) cut to one group (``VLM_SHARDED_LAYERS``: 7.235 B
    params), ``Session.serve(dp=2, tp=2)`` on phase 24's four rank
    processes (``_vlm_router_rank``): two replicas of two ranks, each rank
    32/4 heads, d_ff 14336 and half the vocabulary (~29 GB of bf16 weights
    on the card in all), 4 slots x 1024 on dense rows a replica, phase
    17's six requests with their images, ``ROUTED_VLM_NEW`` new tokens
    each, the split path. Checks on each rank: every request of both
    replicas finishes with in-vocab tokens, both replicas serve, the
    union of the streams is the same on every rank, launches as
    ``_vlm_want`` says on the local replica, its prefill lengths held by
    phase 3, one ``attn_out`` and one ``mlp_out`` sum a layer a program
    on the row. Reports tokens/s (the union over the wall), decode p50,
    peak memory a rank and requests a replica. Then the f32 check at
    ``VLM_F32_CUT``: every rank's union of streams equals a dp 2 router's
    of the same replicas unsharded on one device (run before the ranks
    start), with its homes. Not parallelism's speed: four ranks share one
    card over gloo."""
    from repro_torch.configs import get_config
    one = _vlm_router_f32(seed, "vlm router f32 one device")
    ranks = yield RankJob(_vlm_router_rank, (seed,), ROUTED_VLM_TIMEOUT_S,
                          "vlm router", world=4)
    cfg = get_config("llama-3.2-vision-90b").with_(
        num_layers=VLM_SHARDED_LAYERS)
    g, rest = cfg.vlm_groups
    layers = g * (cfg.cross_attn_every + 1) + rest
    held = {shape[1] for shape in vlm_flash_shapes(seed)}
    r0 = ranks[0]["bfloat16"]
    for r in ranks:
        run, tag = r["bfloat16"], f"[vlm router bf16] rank {r['rank']}"
        check(run["streams"] == r0["streams"] and run["homes"] == r0["homes"],
              f"{tag} streams or homes differ from rank 0's")
        check(sorted(set(run["homes"])) == [0, 1],
              f"{tag} replicas {run['homes']}: both must serve")
        check(run["launches"] == run["want"],
              f"{tag} launches {run['launches']} != {run['want']}")
        check(set(run["prefill_lens"]) <= held,
              f"{tag} prefill lengths {run['prefill_lens']} not all held by "
              f"phase 3")
        programs = run["prefills"] + run["decode_steps"]
        c = run["collectives"]
        check(c.get("attn_out") == c.get("mlp_out") == layers * programs
              > 0, f"{tag} collectives {c}: one attn_out and mlp_out a "
                   f"layer a program ({layers} x {programs})")
        check(run["heads"] == [VLM_TP_HEADS[0], VLM_TP_HEADS[1]],
              f"{tag} heads {run['heads']}")
        f32 = r["float32"]
        check(f32["streams"] == one["streams"]
              and f32["homes"] == one["homes"],
              f"[vlm router f32] rank {r['rank']} streams {f32['streams']} "
              f"(homes {f32['homes']}) != the one-device router's "
              f"{one['streams']} ({one['homes']})")
        check(f32["launches"] == f32["want"],
              f"[vlm router f32] rank {r['rank']} launches "
              f"{f32['launches']} != {f32['want']}")
    note = ("four ranks share one card's SMs and gloo stages each "
            "all-reduce through host memory: not parallelism's speed")
    per_program = {k: round(v / (r0["prefills"] + r0["decode_steps"]), 2)
                   for k, v in r0["collectives"].items()}
    log(f"[vlm router bf16] Llama-3.2-Vision-90B {VLM_SHARDED_LAYERS} layers "
        f"at dp 2 x tp 2 on {smi} ({r0['heads'][0]}/{r0['heads'][1]} heads "
        f"a rank, {r0['weights_gb']:.2f} GB of weights a rank, built in "
        f"{r0['build_s']:.1f}s): {r0['tokens']} tokens in "
        f"{r0['wall_s']:.2f}s = {r0['tokens_per_s']:.2f} tok/s; requests a "
        f"replica {r0['requests_a_replica']} (homes {r0['homes']}); rank "
        f"0's replica: {r0['steps']} steps, step p50 {r0['step_p50_ms']:.1f}"
        f" ms, prefill p50 {r0['prefill_step_p50_ms']:.1f} ms, decode p50 "
        f"{r0['decode_only_step_p50_ms']:.1f} ms; peak memory a rank "
        f"{[round(x['bfloat16']['peak_mem_gb'], 2) for x in ranks]} GB; "
        f"launches a rank {r0['launches']}; collectives a program "
        f"{per_program} — {note}")
    log(f"[vlm router f32] full width, {VLM_F32_CUT}: every rank's union of "
        f"streams equals the one-device dp 2 router's over "
        f"{len(one['streams'])} requests (homes {one['homes']}; one device "
        f"{one['wall_s']:.1f}s, the ranks "
        f"{max(r['float32']['wall_s'] for r in ranks):.1f}s); launches a rank "
        f"{ranks[0]['float32']['launches']}")
    return {"note": note, "card": smi, "ranks": ranks,
            "one_device_f32": one, "bfloat16": r0}


def _pod_rank(rank: int, world: int, seed: int, flat, prompts, big_prompts,
              max_new: int):
    """One rank of phase 38: the tiny f32 config's router on each of
    ``POD_MESHES`` (the mixed step), then Qwen3-14B at
    ``TP_SERVE_LAYERS`` layers behind the router on ``POD_MESH``, the
    rank drawing only its shards from ``seed`` (``init_params(shard=)``:
    the blocks phase 19's ranks draw)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.strategy import Strategy, serving
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.params import from_numpy, init_params
    from repro_torch.serve.parallel import ReplicaRouter
    _tp_rank_setup()
    axes = ("pod", "data", "model")
    cfg = ModelConfig(**TP_PARITY_CFG)
    params = from_numpy(flat, cfg, "cuda")
    out = {"rank": rank}
    meshes = {}
    for shape in POD_MESHES:
        meshes[shape] = mesh = make_mesh(shape, axes, device_type="cuda")
        router = ReplicaRouter(cfg, params, dp=2, tp=2, mesh=mesh, slots=2,
                               max_len=64, **TP_PARITY_LAYOUTS["mixed"])
        streams, launches = _serve_run(router, prompts, None)
        eng = router.engines[0]
        out["x".join(map(str, shape))] = {
            "streams": streams, "launches": launches,
            "want": _want_launches(eng, cfg.num_layers),
            "row": router.row, "rows": router.meshes,
            "coord": [eng._rank.pod_rank, eng._rank.data_rank],
            "root": eng._rank.root,
            "homes": [router.replica_of(i) for i in range(len(prompts))],
            "collectives": dict(eng._rank.counts)}
    del params, router, eng
    big = get_config("qwen3-14b").with_(num_layers=TP_SERVE_LAYERS)
    mesh = meshes[POD_MESH]
    t0 = time.perf_counter()
    shards = init_params(big, device="cuda", seed=seed,
                         shard=(serving(Strategy(dtype=big.dtype)), mesh))
    router = ReplicaRouter(big, shards, dp=2, tp=2, mesh=mesh, slots=4,
                           max_len=1024, page_size=16, chunk_tokens=256)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    run = _rank_router_run(router, big_prompts, max_new,
                           f"pod bf16 rank {rank}")
    eng = router.engines[0]
    run.update(rank=rank, build_s=build_s,
               coord=[eng._rank.pod_rank, eng._rank.data_rank],
               want=_want_launches(eng, big.num_layers),
               heads=[eng._rank.heads, eng._rank.kv_heads],
               weights_gb=sum(v.numel() * v.element_size()
                              for v in _leaves(eng.params)) / 1e9)
    out["bfloat16"] = run
    del router, eng, shards
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_pod_serve(seed: int, smi: str, max_new: int = 16):
    """Phase 38: SERVING ON A ("pod", "data", "model") MESH, on phase 24's
    four rank processes (``_pod_rank``): each ("pod", "data") coordinate
    is one tp 2 replica row, pod major, its collectives on its "model"
    group and its root the row's first rank. Phase 4's tiny f32 dense
    config behind the dp 2 x tp 2 router on (2, 1, 2) and (1, 2, 2), the
    mixed step: on every rank the union of the streams equals the
    unsharded engine's on the card (run here before the ranks start),
    launches as ``_want_launches`` says on the local replica, each rank's
    row its (pod, data) coordinate. Then Qwen3-14B at full width,
    ``TP_SERVE_LAYERS`` layers, behind the router on (2, 1, 2) (phase
    19's settings, six prompts and shards: 20/4 heads x 128, d_ff 8704, half
    the vocabulary a rank), paged mixed step: every request finishes with
    in-vocab tokens, both replicas serve, paged attention and the fused
    MLP once a layer a program, the same union on every rank, and (after
    phase 19) that union equal to phase 19's mixed streams bit for bit (a
    mixed row's bits depend on that row alone). Reports tokens/s, step
    p50 and the collectives by label. Not parallelism's speed: four ranks
    share one card over gloo."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(**TP_PARITY_CFG)
    params = init_params(cfg, device="cuda", seed=3)
    prompts, _ = _family_requests(cfg)
    want, _ = _serve_run(ServeEngine(cfg, params, slots=2, max_len=64,
                                     **TP_PARITY_LAYOUTS["mixed"]),
                         prompts, None)
    flat = {k: v.cpu().numpy() for k, v in flatten(params).items()}
    del params
    _, big_prompts = serving_prompts(seed,
                                     get_config("qwen3-14b").vocab_size)
    big_prompts = [np.asarray(p, np.int32) for p in big_prompts]
    ranks = yield RankJob(_pod_rank, (seed, flat, prompts, big_prompts,
                                      max_new), POD_TIMEOUT_S, "pod serve",
                          world=4)
    for shape in POD_MESHES:
        key = "x".join(map(str, shape))
        for r in ranks:
            got, tag = r[key], f"[pod {key} f32] rank {r['rank']}"
            check(got["streams"] == want,
                  f"{tag} streams {got['streams']} != the unsharded "
                  f"engine's {want}")
            check(got["launches"] == got["want"],
                  f"{tag} launches {got['launches']} != {got['want']}")
            pod, data = got["coord"]
            check(got["row"] == pod * shape[1] + data == r["rank"] // 2
                  and got["rows"] == [(0, 1), (2, 3)]
                  and got["root"] == got["rows"][got["row"]][0],
                  f"{tag} row {got['row']} at {got['coord']}, rows "
                  f"{got['rows']}, root {got['root']}")
            check(sorted(set(got["homes"])) == [0, 1],
                  f"{tag} replicas {got['homes']}")
        log(f"[pod {key} f32] every rank's union of streams equals the "
            f"unsharded engine's on the card over {len(prompts)} requests "
            f"(replicas {ranks[0][key]['homes']}); rows "
            f"{ranks[0][key]['rows']} by (pod, data) "
            f"{[r[key]['coord'] for r in ranks]}; launches rank 0 "
            f"{ranks[0][key]['launches']}")
    r0 = ranks[0]["bfloat16"]
    for r in ranks:
        run, tag = r["bfloat16"], f"[pod bf16] rank {r['rank']}"
        check(run["streams"] == r0["streams"],
              f"{tag} streams differ from rank 0's")
        check(sorted(set(run["homes"])) == [0, 1],
              f"{tag} replicas {run['homes']}")
        check(run["launches"] == run["want"],
              f"{tag} launches {run['launches']} != {run['want']}")
        check(run["row"] == run["coord"][0], f"{tag} row {run['row']} at "
                                             f"{run['coord']}")
    note = ("four ranks share one card's SMs and gloo stages each "
            "all-reduce through host memory: not parallelism's speed")
    mb = {k: round(v / 1e6, 3) for k, v in r0["collective_bytes"].items()}
    log(f"[pod bf16] Qwen3-14B {TP_SERVE_LAYERS} layers on a ('pod', "
        f"'data', 'model') = {POD_MESH} mesh on {smi} ({r0['heads'][0]}/"
        f"{r0['heads'][1]} heads, {r0['weights_gb']:.2f} GB of weights a "
        f"rank, built in {r0['build_s']:.1f}s): {r0['tokens']} tokens in "
        f"{r0['wall_s']:.2f}s = {r0['tokens_per_s']:.2f} tok/s; requests a "
        f"replica {r0['requests_a_replica']}; rank 0's replica "
        f"{r0['steps']} steps, step p50 {r0['step_p50_ms']:.1f} ms; peak "
        f"memory a rank {[round(x['bfloat16']['peak_mem_gb'], 2) for x in ranks]}"
        f" GB; launches a rank {r0['launches']}; collectives rank 0 "
        f"{r0['collectives']} (MB {mb}) — {note}")
    return {"note": note, "card": smi, "ranks": ranks, "bfloat16": r0}


# ------------------------------------------------------------- phase 36

#: phase 36's steps, each a ``ShapeConfig``'s (name, seq_len, batch,
#: kind): phase 6's training step; phase 5b's split-path prefill of one
#: 1024-token prompt, and one decode step of its four rows over a cache
#: of 2048 positions (the split path's batched decode)
DRYRUN_TRAIN = ("train_1x4096", 4096, 1, "train")
DRYRUN_PREFILL = ("prompt_1024", 1024, 1, "prefill")
DRYRUN_DECODE = ("cache_2048", 2048, 4, "decode")
#: the dry-run's temp + arguments against the card's peak over the step
DRYRUN_PEAK_REL = 0.05
#: the device-free record phase 36 prints: lower_one's, on 16 x 16
DRYRUN_RECORD = ("qwen3-14b", "train_4k")


def start_dryrun_record():
    """Start ``python -m repro_torch.launch.dryrun`` of
    :data:`DRYRUN_RECORD` on the 16 x 16 mesh in a process of its own,
    with no card visible (the dry-run is device-free: it runs on the
    card's host beside the other phases); phase 36 reads its record."""
    out = ROOT / "chiprun_out" / "dryrun"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    arch, shape = DRYRUN_RECORD
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out)], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.started, proc.out = time.perf_counter(), out
    return proc


def _counted(step, args):
    """``step(*args)`` once under ``Counter`` with the card's peak reset
    before it: (counter, output, bytes allocated before, peak)."""
    from repro_torch.launch.roofline import Counter
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    counter = Counter()
    with counter:
        out = step(*args)
    torch.cuda.synchronize()
    return counter, out, before, torch.cuda.max_memory_allocated()


def _event_ms(fn, reps: int = 3) -> float:
    """The median of ``reps`` timed calls of ``fn``, by CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _hold_to_dryrun(tag: str, rec: dict, lowered, counter, real_args: int,
                    before: int, peak: int, measured_s: float, smi: str, *,
                    defects: bool) -> dict:
    """Phase 36's checks of one step: the dry-run's FLOPs, bytes and each
    kernel's charge equal to the real step's exactly; its argument bytes
    equal to the real arguments'; its temp + arguments within
    :data:`DRYRUN_PEAK_REL` of the card's peak over the step (the peak
    less what was resident before the step beyond its arguments); the
    measured step at or above the roofline's lower bound. ``defects``:
    each check shown to reject a defect."""
    from repro_torch.launch.roofline import extract
    from repro_torch.launch.specs import tensor_bytes
    meta = lowered.counter
    mem = rec["memory_analysis"]
    row = rec["roofline"]
    check(meta.flops == counter.flops,
          f"[{tag}] dry-run FLOPs {meta.flops!r} != the step's "
          f"{counter.flops!r}")
    check(meta.bytes == counter.bytes,
          f"[{tag}] dry-run bytes {meta.bytes!r} != the step's "
          f"{counter.bytes!r}")
    check(meta.kernels == counter.kernels,
          f"[{tag}] kernels' charges {meta.kernels} != the step's "
          f"{counter.kernels}")
    check(counter.kernels, f"[{tag}] no kernel charged its cost")
    args = mem["argument_size_in_bytes"]
    check(args == real_args, f"[{tag}] argument bytes {args} != the real "
                             f"arguments' {real_args}")
    resident = before - real_args       # held before the step, not its own
    step_peak = peak - resident
    want = args + mem["temp_size_in_bytes"]
    gap = step_peak - want
    check(abs(gap) <= DRYRUN_PEAK_REL * step_peak,
          f"[{tag}] temp + arguments {want} vs the card's {step_peak} over "
          f"the step ({gap:+d} bytes)")
    bound_s = max(row["t_compute_s"], row["t_memory_s"],
                  row["t_collective_s"])
    ratio = measured_s / bound_s
    check(ratio >= 1.0, f"[{tag}] measured {measured_s * 1e3:.3f} ms is "
                        f"below the lower bound {bound_s * 1e3:.3f} ms")
    out = {"flops": counter.flops, "bytes": counter.bytes,
           "kernels": counter.kernels, "argument_bytes": args,
           "temp_bytes": mem["temp_size_in_bytes"],
           "card_peak_over_step": step_peak, "resident_before": resident,
           "peak_gap_bytes": gap, "measured_s": measured_s,
           "lower_bound_s": bound_s, "bottleneck": row["bottleneck"],
           "t_compute_s": row["t_compute_s"],
           "t_memory_s": row["t_memory_s"],
           "measured_over_bound": ratio, "trace_s": rec["compile_s"]}
    if defects:
        kernel_flops = sum(k["flops"] for k in meta.kernels.values())
        skipped = meta.flops - kernel_flops
        check(skipped != counter.flops, f"[{tag}] a counter that skips the "
                                        f"kernels' cost would pass")
        no_opt = tensor_bytes(lowered.args[0], lowered.args[2])
        check(no_opt != real_args, f"[{tag}] a spec without the optimizer "
                                   f"state would pass")
        bare = args                              # the temp left out
        check(abs(step_peak - bare) > DRYRUN_PEAK_REL * step_peak,
              f"[{tag}] a count without the temp would pass")
        wrong = extract(meta, arch="", shape="", mesh_name="", chips=1,
                        model_flops=0.0)
        wrong.hlo_flops *= 256                 # a 16 x 16 mesh's globals
        wrong.hlo_bytes *= 256                 # taken as one chip's
        check(measured_s < wrong.step_time_lower_bound,
              f"[{tag}] a bound of global counts taken as one chip's "
              f"would pass")
        out["defects_rejected"] = ["kernels' cost skipped",
                                   "optimizer state dropped from the spec",
                                   "temp left out of the peak",
                                   "a 16 x 16 mesh's globals as one chip's"]
    log(f"[dryrun {tag}] FLOPs {counter.flops:.6e} = dry-run's, bytes "
        f"{counter.bytes:.6e} = dry-run's, kernels "
        + ", ".join(f"{k} {v['launches']} x" for k, v in
                    counter.kernels.items())
        + f" charged alike; arguments {args / 1e9:.4f} GB = real; temp + "
        f"arguments {want / 1e9:.4f} GB vs the card's "
        f"{step_peak / 1e9:.4f} GB over the step ({gap / 1e6:+.2f} MB; "
        f"{resident / 1e9:.3f} GB resident beyond the arguments before "
        f"it); measured {measured_s * 1e3:.3f} ms vs lower bound "
        f"{bound_s * 1e3:.3f} ms ({row['bottleneck']}): "
        f"{ratio:.3f}x; traced in {rec['compile_s']:.3f} s on {smi}"
        + ("; defects rejected: " + ", ".join(out["defects_rejected"])
           if defects else ""))
    return out


def phase_dryrun_serve(session, seed: int, smi: str) -> dict:
    """Phase 36 on phase 5's session (16 layers): :data:`DRYRUN_PREFILL`
    and :data:`DRYRUN_DECODE` dry-run on meta as the card's branch, then
    run once for real under the same ``Counter`` and held
    (``_hold_to_dryrun``); their launches join the kernels' sums."""
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import tensor_bytes
    from repro_torch.models import get_model
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    cfg, st = session.cfg, session.strategy
    rng = np.random.default_rng(seed + 36)
    params = session.params
    out = {}
    kernels.reset_launches()
    shape = ShapeConfig(*DRYRUN_PREFILL)
    rec, lowered = Session(cfg, strategy=st, device="cuda").lower(shape)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (shape.global_batch, shape.seq_len)).astype(
            np.int32)).cuda()
    step = make_prefill_step(cfg, st)
    with torch.no_grad():
        args = (params, {"tokens": tokens})
        counter, res, before, peak = _counted(step, args)
        del res
        ms = _event_ms(lambda: step(*args))
    out["prefill"] = _hold_to_dryrun(
        "prefill", rec, lowered, counter, tensor_bytes(args), before, peak,
        ms / 1e3, smi, defects=False)
    shape = ShapeConfig(*DRYRUN_DECODE)
    rec, lowered = Session(cfg, strategy=st, device="cuda").lower(shape)
    model = get_model(cfg)
    with torch.no_grad():
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (shape.global_batch, 1024)).astype(
                np.int32)).cuda()
        cache = model.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="cuda")
        logits, cache = model.prefill(params, {"tokens": prompts}, cfg,
                                      cache)
        token = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = torch.tensor(1024, dtype=torch.int32, device="cuda")
        del logits
        step = make_decode_step(cfg, st)
        args = (params, cache, token, pos)
        counter, res, before, peak = _counted(step, args)
        del res
        ms = _event_ms(lambda: step(*args))
    out["decode"] = _hold_to_dryrun(
        "decode", rec, lowered, counter, tensor_bytes(args), before, peak,
        ms / 1e3, smi, defects=False)
    del cache, args
    out["launches"] = kernels.launches()
    return out


def phase_dryrun_train(session, phase6: dict, proc, smi: str) -> dict:
    """Phase 36 on phase 6's session (4 layers, its trained params):
    :data:`DRYRUN_TRAIN` dry-run on meta, then phase 6's step once for
    real on a new trainer of the session under the same ``Counter``,
    held (``_hold_to_dryrun``, the measured step phase 6's p50), each
    check shown to reject a defect; then the device-free record of
    :data:`DRYRUN_RECORD` on 16 x 16 from ``proc``
    (``start_dryrun_record``), printed with its trace seconds."""
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import tensor_bytes
    from repro_torch.train.trainer import TrainConfig
    cfg = session.cfg
    shape = ShapeConfig(*DRYRUN_TRAIN)
    check(phase6["seq_len"] == shape.seq_len and phase6["layers"]
          == cfg.num_layers, f"phase 6 ran {phase6['seq_len']} tokens on "
          f"{phase6['layers']} layers, phase 36 {shape}")
    rec, lowered = session.lower(shape)
    trainer = session.train(TrainConfig(steps=1, seed=0),
                            global_batch=shape.global_batch,
                            seq_len=shape.seq_len)
    tokens = torch.from_numpy(trainer.data.batch(0)["tokens"]).cuda()
    args = (trainer.params, trainer.opt_state, {"tokens": tokens})
    kernels.reset_launches()
    counter, res, before, peak = _counted(trainer._step_fn, args)
    del res
    out = {"train": _hold_to_dryrun(
        "train", rec, lowered, counter, tensor_bytes(args), before, peak,
        phase6["step_p50_s"], smi, defects=True),
        "launches": kernels.launches()}
    del trainer, args
    text, _ = proc.communicate(timeout=900)
    wall = time.perf_counter() - proc.started
    check(proc.returncode == 0, f"[dryrun record] launch/dryrun.py exited "
                                f"{proc.returncode}: {text[-2000:]}")
    arch, name = DRYRUN_RECORD
    path = proc.out / f"{arch}__{name}__pod16x16__base.json"
    full = json.loads(path.read_text())
    row = full["roofline"]
    out["record"] = full
    out["record_wall_s"] = wall
    log(f"[dryrun record] lower_one({arch!r}, {name!r}) on 16 x 16, rank 0 "
        f"as the card's branch, on the card's host with no card visible: "
        f"traced in {full['compile_s']:.3f} s ({wall:.1f} s of its "
        f"process, beside the phases); strategy {full['strategy_detail']}; "
        f"memory {full['memory_analysis']}; t_compute "
        f"{row['t_compute_s']:.4e} s, t_memory {row['t_memory_s']:.4e} s, "
        f"t_collective {row['t_collective_s']:.4e} s ({row['bottleneck']}), "
        f"useful {row['useful_ratio']:.4f}, mem/device "
        f"{row['mem_per_device_gb']:.3f} GB, ICI "
        f"{row['coll_ici_bytes_per_dev']:.4e} B, DCN "
        f"{row['coll_dcn_bytes_per_dev']:.4e} B (data-sheet predictions)")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_all = time.perf_counter()
    phase_s, t_last = {}, [t_all]

    def mark(name):                   # wall seconds since the last mark
        now = time.perf_counter()
        phase_s[name] = now - t_last[0]
        t_last[0] = now

    smi = phase_card()
    record = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "seed": args.seed}
    record["build_s"], record["sass"] = phase_build()
    # phase 36's device-free record runs on the host beside the phases
    dryrun_proc = start_dryrun_record()
    mark("1-2 card, build")
    rng = np.random.default_rng(args.seed)
    kernels = [phase_attention(rng), phase_mlp(rng), phase_flash(rng),
               phase_ssd(rng)]
    mark("3 kernels")
    hybrid_shapes = phase_hybrid_kernels(rng)
    for k in kernels:
        if k["name"] in hybrid_shapes:
            k["hybrid_shapes"] = hybrid_shapes[k["name"]]
    kernels[1]["hybrid_seed_sweep"] = hybrid_shapes["fused_mlp_seed_sweep"]
    mark("3 kernels at the hybrid's shapes")
    moe_shapes = phase_moe_kernels(args.seed)
    for k in kernels:
        if k["name"] in moe_shapes:
            k["olmoe_shapes"] = moe_shapes[k["name"]]
    mark("3 kernels at OLMoE's shapes")
    whisper_shapes = phase_whisper_kernels(args.seed)
    for k in kernels:
        if k["name"] in whisper_shapes:
            k["whisper_shapes"] = whisper_shapes[k["name"]]
    mark("3 kernels at whisper-tiny's shapes")
    vlm_shapes = phase_vlm_kernels(args.seed)
    for k in kernels:
        if k["name"] in vlm_shapes:
            k["vlm_shapes"] = vlm_shapes[k["name"]]
    kernels[1]["vlm_seed_sweep"] = vlm_shapes["fused_mlp_seed_sweep"]
    mark("3 kernels at Llama-3.2-Vision's shapes")
    tp_shapes = phase_tp_kernels(args.seed)
    for k in kernels:
        if k["name"] in tp_shapes:
            k["tp_shapes"] = tp_shapes[k["name"]]
    mark("3 kernels at tensor-parallel Qwen3-14B's rank shapes")
    family_shapes = phase_tp_family_kernels(args.seed)
    for k in kernels:
        if k["name"] in family_shapes:
            k["tp_family_shapes"] = family_shapes[k["name"]]
    mark("3 kernels at OLMoE's and whisper-tiny's tp 2 rank shapes")
    cp_shapes = phase_cp_kernels(args.seed)
    for k in kernels:
        if k["name"] in cp_shapes:
            k["cp_shapes"] = cp_shapes[k["name"]]
    mark("3 kernels at the context-parallel Qwen3-14B's new shapes")
    train_tp_shapes = phase_train_tp_kernels(args.seed)
    for k in kernels:
        if k["name"] in train_tp_shapes:
            k["train_tp_shapes"] = train_tp_shapes[k["name"]]
    mark("3 kernels at the sharded training's rank shapes")
    pipe_shapes = phase_pipe_kernels(args.seed)
    for k in kernels:
        if k["name"] in pipe_shapes:
            k["pipe_shapes"] = pipe_shapes[k["name"]]
    mark("3 kernels at the pipeline's shapes")
    ssm_tp_shapes = phase_ssm_tp_kernels(args.seed)
    for k in kernels:
        if k["name"] in ssm_tp_shapes:
            k["ssm_tp_shapes"] = ssm_tp_shapes[k["name"]]
    mark("3 kernels at the SSM family's and the hybrid's tp 2 rank shapes")
    whisper_tp_shapes = phase_whisper_train_tp_kernels(args.seed)
    for k in kernels:
        if k["name"] in whisper_tp_shapes:
            k["whisper_train_tp_shapes"] = whisper_tp_shapes[k["name"]]
    mark("3 kernels at whisper-tiny's sharded training rank shapes")
    vlm_tp_shapes = phase_vlm_tp_kernels(args.seed)
    for k in kernels:
        if k["name"] in vlm_tp_shapes:
            k["vlm_tp_shapes"] = vlm_tp_shapes[k["name"]]
    mark("3 kernels at Llama-3.2-Vision's tp 2 rank shapes")
    moe_train_tp_shapes = phase_moe_train_tp_kernels(args.seed)
    for k in kernels:
        if k["name"] in moe_train_tp_shapes:
            k["moe_train_tp_shapes"] = moe_train_tp_shapes[k["name"]]
    mark("3 kernels at OLMoE-1B-7B's sharded training rank shapes")
    parity = phase_parity()
    record["parity_logits_err"] = parity.pop("mixed")
    record["parity_split_logits_err"] = parity
    record["parity_prefix"] = phase_parity_prefix()
    record["parity_spec"] = phase_parity_spec()
    record["parity_ssm_logits_err"] = phase_parity_ssm()
    record["parity_train"] = phase_train_parity()
    mark("4 parity")
    record["parity_hybrid_logits_err"] = phase_parity_hybrid()
    record["parity_train_families"] = phase_train_parity_families()
    mark("4 parity: hybrid, SSM and hybrid training")
    record["parity_moe"] = phase_parity_moe()
    mark("4 parity: MoE serving and training")
    record["parity_audio"] = phase_parity_audio()
    mark("4 parity: audio serving and training")
    record["parity_vlm"] = phase_parity_vlm()
    mark("4 parity: VLM serving and training")
    # the phases on rank processes run up to their RankJob in this order;
    # their jobs then run together on one set of four rank processes and
    # one of two (``_run_jobs``), and each phase's checks after them
    fours, pairs = {}, {}
    pairs["parity_tp"] = _start(phase_parity_tp())
    pairs["parity_tp_families"] = _start(phase_parity_tp_families())
    fours["parity_dp"] = _start(phase_parity_dp())
    pairs["parity_cp"] = _start(phase_parity_cp())
    mark("4 parity: dp 2, and the unsharded runs of the gloo parity runs")
    main_run, eng, session, prompts = phase_main(args.seed)
    record["main"] = main_run
    record["profile"] = phase_profile(eng, rng, main_run["step_p50_ms"])
    del eng                               # free phase 5's pool
    gc.collect()
    torch.cuda.empty_cache()
    record["split"] = phase_split(session, prompts, main_run["streams"],
                                  args.seed)
    record["prefix"] = phase_prefix(session, args.seed)
    record["spec"], streams_b, spec_prompts = phase_spec(session, args.seed)
    record["online"] = phase_online(session, spec_prompts, streams_b)
    mark("5-10 dense serving")
    record["dp"] = phase_dp_serve(session, main_run,
                                  record["prefix"]["B: mixed, prefix cache"],
                                  args.seed)
    mark("20 data-parallel serving")
    record["plan_serve"] = phase_plan_serve(session, main_run, prompts,
                                            args.seed)
    mark("34 serving from a plan")
    record["dryrun_serve"] = phase_dryrun_serve(session, args.seed, smi)
    mark("36 dry-run against the card: prefill, decode")
    del session                           # free the serving weights
    gc.collect()
    torch.cuda.empty_cache()
    pairs["tp"] = _start(phase_tp_serve(args.seed, main_run))
    pairs["plan_tp"] = _start(phase_plan_tp_serve(args.seed))
    pairs["cp"] = _start(phase_cp_serve(args.seed, smi))
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    train_session = Session(get_config("qwen3-14b").with_(num_layers=4),
                            device="cuda", seed=args.seed)
    record["train"] = phase_train(args.seed, session=train_session)
    mark("6 dense training")
    gc.collect()                          # phase 6's trainer died with it
    torch.cuda.empty_cache()
    record["dryrun_train"] = phase_dryrun_train(train_session,
                                                record["train"], dryrun_proc,
                                                smi)
    del train_session
    gc.collect()                          # phase 36's trainer and session
    torch.cuda.empty_cache()
    mark("36 dry-run against the card: training, and the 16 x 16 record")
    record["plan_train"] = phase_plan_train(args.seed, record["train"])
    mark("34 training from a plan")
    gc.collect()
    torch.cuda.empty_cache()
    fours["sharded_train"] = _start(phase_train_sharded(args.seed, smi))
    fours["plan_sharded"] = _start(phase_plan_sharded(args.seed))
    mark("33's one-device f32 step")
    fours["vlm_router"] = _start(phase_vlm_router(args.seed, smi))
    fours["pod"] = _start(phase_pod_serve(args.seed, smi))
    gc.collect()
    torch.cuda.empty_cache()
    mark("37's one-device f32 router, 38's unsharded f32 engine")
    record["ssm"] = phase_ssm(args.seed)
    mark("7 SSM serving")
    gc.collect()
    torch.cuda.empty_cache()
    record["hybrid"] = phase_hybrid(args.seed)
    mark("11 hybrid serving")
    gc.collect()
    torch.cuda.empty_cache()
    record["train_families"] = phase_train_families(args.seed)
    mark("12 SSM and hybrid training")
    gc.collect()
    torch.cuda.empty_cache()
    record["moe"] = phase_moe_serve(args.seed)
    mark("13-13b MoE serving")
    pairs["moe_tp"] = _start(phase_family_tp_serve("olmoe-1b-7b", args.seed,
                                                   record["moe"], 16))
    mark("32's one-device f32 run")
    gc.collect()
    torch.cuda.empty_cache()
    # phase 6's run on OLMoE-1B-7B at 4 layers: its 16 would need ~110 GB
    record["moe_train"] = phase_train(args.seed, layers=4,
                                      arch="olmoe-1b-7b")
    mark("14 MoE training")
    gc.collect()
    torch.cuda.empty_cache()
    record["audio"] = phase_whisper_serve(args.seed)
    mark("15-15b audio serving")
    pairs["audio_tp"] = _start(phase_family_tp_serve(
        "whisper-tiny", args.seed, record["audio"], WHISPER_NEW))
    gc.collect()
    torch.cuda.empty_cache()
    record["audio_train"] = phase_whisper_train(args.seed)
    mark("16 audio training")
    gc.collect()
    torch.cuda.empty_cache()
    record["vlm"] = phase_vlm_serve(args.seed)
    mark("17 VLM serving")
    record["vlm_train"] = phase_vlm_train(args.seed)
    mark("18 VLM training")
    gc.collect()
    torch.cuda.empty_cache()
    pairs["ssm_tp"] = _start(phase_ssm_tp_serve(
        args.seed, {"mamba2-780m": record["ssm"],
                    "zamba2-1.2b": record["hybrid"]}, smi))
    mark("27 and 30's one-device f32 runs")
    record.update(_run_jobs(fours, "parity dp 2 x tp 2, sharded train, "
                                   "pipeline, SSM, whisper, VLM and MoE "
                                   "sharded train, VLM router, pod mesh"))
    record["pipeline"] = phase_pipeline(
        [dict(r.pop("pipe"), rank=r["rank"])
         for r in record["sharded_train"]["ranks"]], smi)
    record["ssm_sharded_train"] = phase_ssm_train_sharded(
        record["sharded_train"]["ranks"], smi)
    record["whisper_sharded_train"] = phase_whisper_train_sharded(
        record["sharded_train"]["ranks"], smi)
    record["vlm_sharded_train"] = phase_vlm_train_sharded(
        record["sharded_train"]["ranks"], smi)
    record["moe_sharded_train"] = phase_moe_train_sharded(
        record["sharded_train"]["ranks"], smi)
    mark("4 parity dp 2 x tp 2; 24-25, 28-29, 31, 33 sharded training, "
         "the pipeline, SSM, enc-dec, VLM and MoE sharded training; 37 the "
         "VLM router; 38 the pod mesh")
    record.update(_run_jobs(pairs, "parity tp 2, families and cp; tp, cp, "
                                   "MoE, audio, SSM, hybrid and VLM tp "
                                   "serve"))
    record["tp_online"] = phase_online_tp(
        [dict(r.pop("online"), rank=r["rank"])
         for r in record["tp"]["ranks"]], record["tp"], smi)
    record["moe_tie"] = phase_moe_tie_serve(
        [r.pop("tie") for r in record["moe_tp"]["ranks"]],
        record["moe_tp"].pop("tie_one_device_f32"), record["moe"],
        record["moe_tp"], smi)
    record["vlm_tp"] = phase_vlm_tp_serve(
        [r.pop("vlm") for r in record["ssm_tp"]["ranks"]],
        record["ssm_tp"].pop("vlm_one_device_f32"), record["vlm"], smi)
    mark("4 parity at tp 2; 19, 26, 23, 21, 32, 22, 27, 30 tensor- and "
         "context-parallel serving")
    record["plan_ranks"] = phase_plan_ranks(
        record.pop("plan_tp"), record["tp"], record.pop("plan_sharded"),
        record["sharded_train"], smi)
    mark("35 a plan's serving and training on ranks")
    # phase 38's Qwen3-14B replicas hold phase 19's shards and serve its
    # prompts at its settings: a mixed row's bits depend on that row alone
    pod, tp2 = record["pod"]["bfloat16"], record["tp"]["mixed"]
    check(pod["streams"] == tp2["streams"],
          f"[pod bf16] the union of streams {pod['streams']} != phase 19's "
          f"mixed streams {tp2['streams']}")
    log("[pod bf16] the union of the pod mesh's streams equals phase 19's "
        "tp 2 mixed streams bit for bit")
    # each kernel's launches on the paths that run it, each counted from 0
    # just before its run: phase 5 and phases 9-10 (paged attention, the
    # fused MLP; flash in phase 9's model drafter), phase 6 (flash), phase
    # 7 (the SSD scan), phase 11 (the SSD scan, flash, the fused MLP, and
    # generate's), phase 12 (flash in the hybrid's shared block), phase 13
    # (paged attention), phase 13b (flash, paged attention), phase 14
    # (flash), phase 15 (paged attention, flash in the encoder), phase 15b
    # (flash, paged attention), phase 16 (flash), phase 17 (flash, the
    # fused MLP), phase 18 (flash), phase 19 (each rank: paged attention
    # and the fused MLP on the mixed step, flash, paged attention and the
    # fused MLP on the split path), phase 26 (each rank: paged attention
    # and the fused MLP in runs A and B), phase 20 (paged attention and the
    # fused MLP, both runs), phases 21 and 22 (each rank: paged attention
    # on the mixed step, flash in whisper-tiny's encoder there, flash and
    # paged attention on the split path), phase 23 (each rank: flash and
    # the fused MLP on the CP and the head-sharded paths), phase 24 (each
    # rank: flash in each of the ZeRO-1, FSDP and SP runs), phase 25 (each
    # rank: flash and the fused MLP in the no_grad runs, flash in the
    # forward + backward runs; the last repeat of each), phase 27 (each
    # rank: the SSD scan in both models' prefills, flash and the fused MLP
    # in Zamba2's, bf16 and f32), phase 28 (each rank, each run: none),
    # phase 29 (each rank, each run: flash in the encoder, the decoder and
    # its remat recompute), phase 30 (each rank: flash and the fused MLP,
    # bf16 and f32), phase 31 (each rank: flash and its remat recompute),
    # phase 32 (each rank: paged attention on the mixed step, bf16 and
    # f32), phase 33 (each rank, each run: flash and its remat recompute),
    # phase 34 (paged attention and the fused MLP serving, flash
    # training), phase 35 (each rank: paged attention and the fused MLP
    # serving at tp 2, flash training at dp 2 x tp 2), phase 36 (flash
    # and the fused MLP in the prefill, the fused MLP in the decode, flash
    # in the training step; each counted run and each timed repeat), phase
    # 37 (each rank: flash and the fused MLP, bf16 and f32), phase 38 (each
    # rank: paged attention and the fused MLP on both pod meshes, f32, and
    # on Qwen3-14B's, bf16)
    paths = [main_run, record["train"], record["ssm"],
             *record["spec"].values(), *record["online"].values(),
             record["hybrid"], *record["train_families"].values(),
             record["moe"]["mixed"], record["moe"]["split"],
             record["moe_train"], record["audio"]["mixed"],
             record["audio"]["split"], record["audio_train"], record["vlm"],
             record["vlm_train"],
             # phase 19: each rank's own launches, on both paths
             *(r[name] for r in record["tp"]["ranks"]
               for name in ("mixed", "split")),
             # phase 26: each rank's own launches, in runs A and B
             *(r[name] for r in record["tp_online"]["ranks"]
               for name in ("A", "B")),
             *(record["dp"][name] for name in record["dp"]
               if name != "note"),
             *(r[name] for phase in ("moe_tp", "audio_tp")
               for r in record[phase]["ranks"]
               for name in ("mixed", "split")),
             *(r[name] for r in record["cp"]["ranks"]
               for name in ("cp", "heads")),
             # phase 24: each rank's own launches, in each of its runs
             *(r[name] for r in record["sharded_train"]["ranks"]
               for name in SHARDED_RUNS),
             # phase 25: each rank's own launches, in each of its runs
             *(run for r in record["pipeline"]["ranks"]
               for run in r["runs"].values()),
             # phase 27: each rank's own launches, each model and dtype
             *(r[arch][dtype] for r in record["ssm_tp"]["ranks"]
               for arch in SSM_TP_SSD for dtype in ("bfloat16", "float32")),
             # phases 28-29: each rank's own launches, in each of its runs
             *(r[name] for phase in ("ssm_sharded_train",
                                     "whisper_sharded_train")
               for r in record[phase]["ranks"] for name in SHARDED_RUNS),
             # phase 30: each rank's own launches, bf16 and f32
             *(r[dtype] for r in record["vlm_tp"]["ranks"]
               for dtype in ("bfloat16", "float32")),
             # phase 31: each rank's own launches
             *(r[name] for r in record["vlm_sharded_train"]["ranks"]
               for name in VLM_SHARDED_RUNS),
             # phase 32: each rank's own launches, bf16 and f32
             *(r[dtype] for r in record["moe_tie"]["ranks"]
               for dtype in ("bfloat16", "float32")),
             # phase 33: each rank's own launches, in each of its runs
             *(r[name] for r in record["moe_sharded_train"]["ranks"]
               for name in MOE_SHARDED_RUNS),
             # phase 34: serving and training from a plan
             record["plan_serve"], record["plan_train"],
             # phase 35: each rank's own launches, serving and training
             *record["plan_ranks"]["tp_ranks"],
             *record["plan_ranks"]["sharded_ranks"],
             # phase 36: the real steps held to their dry-runs
             record["dryrun_serve"], record["dryrun_train"],
             # phase 37: each rank's own launches, bf16 and f32
             *(r[dtype] for r in record["vlm_router"]["ranks"]
               for dtype in ("bfloat16", "float32")),
             # phase 38: each rank's own launches, each mesh and Qwen3-14B
             *(r[key] for r in record["pod"]["ranks"]
               for key in ["x".join(map(str, m)) for m in POD_MESHES]
               + ["bfloat16"])]
    for k in kernels:
        k["launches"] = sum(run["launches"][k["name"]] for run in paths)
    record["kernels"] = kernels
    record["total_s"] = time.perf_counter() - t_all
    record["phase_s"] = phase_s
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    # nvcc, cuobjdump, the rank processes and the resource tracker their
    # start launched: each must have ended and been reaped by now
    left = child_processes()
    check(not left, f"processes this run started are still there: {left}")
    log(f"[done] {record['total_s']:.1f}s on {smi}; by phase: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in phase_s.items()))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
