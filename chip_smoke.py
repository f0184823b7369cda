#!/usr/bin/env python3
"""Drive the PyTorch port (production_stack_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile the three kernel sources (csrc/paged_attention.cu,
   paged_decode.cu, paged_prefill.cu; the first and last include the
   tile of paged_tile.cuh) and csrc/graph_gate.cu (the fused loop's
   gated iteration graph), one nvcc each, all at once, and link them
   into one library (route: plain C interface + ctypes); print the
   compiler's register/spill report;
2. kernels: random inputs from a seed at Llama-3.2-3B attention shapes
   (nq=24, nkv=8, d=128, bs=32, bf16, a 28-layer cache past 2^31
   elements) run through each kernel and its plain PyTorch version on
   the card, in bf16 and again in f32 on the same inputs; prints max
   error against the stated tolerance, the kernel's time (mean of 20
   calls, each after an L2 flush, CUDA events around the call: the
   card's work and whatever of the wrapper's host enqueue it waits for),
   beside it the device time per call from torch.profiler and the
   host's enqueue time per call, the plain version's time, the least
   time the card could take (bound) and one PyTorch library call on the
   same function as a yardstick, the fastest of those tried: for ragged
   and prefill one SDPA (enable_gqa) over each lane's context read once,
   the lanes' contexts end to end under a block-causal mask; for decode
   one SDPA of each lane's row over its context padded to the table
   width. For each kernel it also prints the grid (split count), shared
   memory, achieved GB/s or TFLOP/s and bound / kernel time. The ragged
   kernel is also checked and timed on the decode lanes alone, packed as
   the model runner packs a decode step (one single-row segment per
   lane), beside the decode kernel on the same lanes; then each kernel
   through its *_tp wrapper at one rank's local shape of the 3B at tp=2
   (nq=12 over nkv=4, d=128, bs=32), bf16 and f32 against the plain
   version, its time beside the profiler's device time and the host
   enqueue a call, its bound and the library call at that shape. The
   same checks and timings again at Gemma-7B's attention shapes (28
   layers, nq=16, nkv=16, d=256) and Gemma-2B's (18 layers, nq=8,
   nkv=1, d=256), bs=32, bf16 and f32 (GEMMA_KERNEL_SHAPES), each line
   tagged with the model;
3. forward: the same random params through models/llama.forward on the
   CPU (plain versions) and on the card (kernels), 2 layers at full 3B
   width, bf16; logits held to a stated tolerance;
4. families: HF checkpoints of the published configs of Qwen2-7B (28
   query heads over 4 kv heads, qkv bias), Mistral-7B-v0.1 (a 4096-token
   window) and Llama-3.2-1B (head_dim 64, tied embeddings), cut to 2
   layers, written from seeded params (models/debug_checkpoint.py),
   read back through models/weights.py onto the card byte for byte,
   logits held to the CPU as in phase 3, and an engine booted on each
   directory generates; a 5000-token Mistral prompt (past its window,
   ten prefill chunks) on the prefill kernel is held to the same
   forward on the plain attention on the card; Gemma-7B and Gemma-2B
   (head_dim 256) among them: each engine booted under auto resolves
   to pallas with no warning and launches the kernels 2 times a forward
   (the ragged kernel, and on a --no-ragged-kernel engine the prefill
   and decode kernels), and one layer's attention at Gemma's heads is
   timed on the three kernels beside the gather path (CUDA events);
   Phi-3-mini (head_dim 96, a 2047-token window), whose head_dim the
   kernels lack, the same at 2 layers on the gather path (logits card
   vs CPU, a 3000-token prompt past its window held to the prefill
   kernel's plain version on the card): an engine booted under
   attention_impl auto resolves to xla, logs "attention impl: xla
   (head_dim 96 not in (64, 128, 256))" and generates with no kernel
   launch, and under pallas it is refused at boot naming its head_dim;
5. serve: the port's CLI (python -m production_stack_tpu_torch.engine)
   starts its OpenAI server on loopback with llama-3.2-3b (all 28
   layers, random bf16 weights, byte tokenizer) on its default config
   (unified ragged rounds, prefill pipeline, decode prefetch) with
   --precompile-serving in a child process: its warm-up log line is
   there when /health first answers; /health, /v1/models, a greedy completion, a streamed
   completion, a chat request, 4 concurrent multi-chunk completions
   (packed prefill or mixed rounds, on the ragged kernel), then a
   ~1500-token prompt (three 512-token chunks) sent while four greedy
   requests decode, so its chunks ride mixed rounds (tpu:ragged_rounds
   > 0 on /metrics), then one prompt sent twice; checks token counts,
   finish reasons and usage, that /metrics (parsed with the standard
   library) has the four families the router parses with a prefix-cache
   hit rate above 0 and one scheduling delay per finished request, and
   that the ragged kernel launched 28 times a forward and the prefill
   kernel 28 times a single-sequence prefill, and that /metrics carries
   tpu:compile_events_total; prints the staged prefill hits, misses and
   chained chunks. Then the OpenAI request surface on
   the same server, launch counts zeroed before it: guided_json,
   guided_regex (two), guided_choice and a chat's response_format
   json_schema, each answer parsed and held to its constraint; n = 3
   (equal greedy choices) and a batched prompt of 4; a chat with tools
   and a named tool_choice (the call forced by a guided_regex, since
   random weights write none) in the OpenAI tool_calls shape;
   /tokenize -> /detokenize round trip and /version; /sleep while a
   request decodes (no token in 0.5 s, /is_sleeping true), then
   /wake_up and the request finishes; prompt_logprobs 5 of a
   1500-token prompt (three chunks) held to the log-softmax of one
   forward of the whole prompt on the card (the server's seeded
   weights) within LOGIT_REL_TOL of max|logit|; /v1/embeddings on three
   texts, the last 1500 tokens (three chunks over the embedding's own
   scratch cache), twice: unit-norm vectors, equal across the calls,
   each within EMBED_MIN_COSINE of a mean-pooled one-shot forward of its
   ids on the card, and /v1/rerank and /v1/score equal to the cosines of
   those vectors; /debug/requests lists each request's timeline from
   enqueue to finish;
6. decode kernel: one ModelRunner.decode step of the 28-layer model over
   the same cache state on the ragged kernel and on
   paged_decode_attention, logits held to a stated tolerance, which the
   same step with a planted fault (a lane longer than one split loses
   its last split) must exceed; then an in-process LLMEngine with
   --no-ragged-kernel drives paged_decode_attention, and its greedy
   tokens are compared with a ragged-kernel engine's: the two kernels
   sum in different orders, so a divergence passes only where the
   ragged engine's top-2 logprob gap at the first differing step is
   below the largest logit difference the direct step measured (the
   first divergence is printed);
6b. guided: in-process 28-layer bf16 engines, K=8 (default config)
   and K=1, serve the four guided constraints beside four free lanes:
   the K=8 engine's fused rounds must run the guided lanes on the
   device DFA tables (runner.guided_rounds), every answer must satisfy
   its constraint, and the K=8 streams are held to the K=1
   (host-masked) engine's under the near-tie rule; prints the TokenDFA
   builds' ms at V = 128256, the DFA step's µs an iteration at b = 8
   (eager, and device time from a CUDA graph), and the wall ms a
   generated token at batch 8 of 8 guided lanes against 8 free ones,
   in turns;
7. pipeline: an in-process 28-layer bf16 engine on the default config
   takes a cold ~1500-token prompt alone and must chain its three
   512-token chunks in one engine step with one fetch; the buffers of
   stage_prefill, stage_prefill_batch, stage_decode_multi and
   stage_ragged, read back after their copy events, must equal byte for
   byte what the unstaged dispatch builds from the same arguments, and a
   packed prefill on a staged buffer must give the unstaged one's tokens
   and logits; prints the prefill phase seconds (prep, h2d, dispatch,
   fetch) of the same prompts on this engine and on one with
   --no-prefill-pipeline --no-prefetch-decode;
8. mixed rounds: in-process 28-layer bf16 engines with
   num_scheduler_steps=8 (unified ragged rounds, device stops, adaptive
   K), one on the default config and one without the prefill pipeline
   and the decode prefetch, and a split K=1 engine, serve four greedy
   requests and a ~1500-token prompt arriving while they decode; the
   default engine must consume staged decode and ragged rounds, and its
   greedy streams are held to both other engines' under the decode
   phase's near-tie rule, every engine's launches to 28 a forward. Then
   wall ms per generated token at batch 8 on each engine, the wall time
   of each mixed round, and a torch.profiler breakdown of one mixed
   round's device time (host clock; reported beside the card's name and
   power limit and the reads taken before staging existed, not
   claims);
8b. impl: the composed ragged round and the gather path beside the
   ragged kernel, in-process 28-layer bf16 engines at K=8 on the same
   seeded weights: the default engine, one with --no-ragged-kernel
   (attention_impl pallas) and one with --attention-impl xla serve the
   mixed phase's scenario and decode at batch 8, in turns ragged,
   composed, gather, gather, composed, ragged; the composed engine
   launches the prefill kernel 28 times per single-sequence prefill and
   per padded prefill lane of a packed forward and the decode kernel 28
   times a decode forward, the ragged kernel never, the gather engine
   no kernel; their greedy streams are held to the ragged-kernel
   engine's under the near-tie rule; wall ms a token printed;
8d. compiled: the decode programs as CUDA graphs (every engine of the
   script runs them; this phase holds them to their eager control). A
   K=8 3B engine on the defaults, contexts capped at
   COMPILED_MAX_MODEL_LEN and chunks at COMPILED_MAX_PREFILL_CHUNK, runs
   precompile_serving (dispatches, seconds, grid, compile events by
   kind, graph pool bytes printed) and then, in turns with an eager
   engine (ModelRunner(eager=True)) on the same params, the mixed
   phase's scenario greedy without logprobs: no compile event in the
   graphed turns, launches 28 a forward counted on replay and equal to
   the eager engine's, greedy streams equal (a parting is held to the
   near-tie rule on the eager engine's logprobs), one mixed round of
   each under torch.profiler (busy share); decode at batch 8 in turns
   (wall ms a token) and one pure decode round of each under the
   profiler; then the same with split K=1 engines (single-step decode
   graphs, host sampling);
8f. sync: the host syncs of the served path, held to the port's
   analyzer. `python -m production_stack_tpu_torch.analysis
   production_stack_tpu_torch/` must exit 0 (run here, on the card's
   Python, with --json, beside the engines); the compiled phase's K=8
   3B engine on the defaults (ragged kernel, unified rounds, graphed
   decode programs after precompile_serving; its context cap) and a
   --no-ragged-kernel one (the prefill and decode kernels; its own
   precompile_serving) each serve the mixed scenario then eight
   32-token prompts at batch 8, prefix cache emptied before each run,
   first plain, then under CUDA's sync debug mode ("warn") with
   torch.cuda.synchronize, Event.synchronize and Stream.synchronize
   wrapped (the debug mode's own report of each explicit call is
   printed: it misses some). Every sync is counted at the innermost
   frame inside the package; syncs a step by round kind (mean and max),
   each site's count, its most frequent caller and the analyzer's
   verdict (a suppressed device-sync finding at that line, or the
   not-hot function around it) are printed, graph capture apart. A site
   the analyzer does not report, streams under the census that differ
   from the plain run's, a compile event in either run, a sync inside
   the fused loop, a captured loop's forward after every lane was done
   (the stop-token scenario of scripts/chip_early_exit.py) or launches
   other than 28 a forward fail the run;
8e. async: a K=8 --async-decode engine against the synchronous K=8
   engine on 8 prompts (4 greedy, 4 seeded sampled): streams
   bit-identical, rounds chained on device tokens > 0, launches 28 a
   forward, wall ms a token at batch 8 in turns;
8c. spec: in-process bf16 engines of the 3B at full width and
   CKPT_LAYERS layers (a checkpoint) on the default config with
   --num-speculative-tokens 4 and without it, in turns: a repetitive
   prompt at batch 1 (turns spec, plain, plain, spec; wall ms a
   generated token printed), then batch 8 with 4 greedy and 4 seeded
   sampled lanes, 64 tokens each: greedy streams part only under the
   near-tie rule, sampled ones only where a rank could change hands
   under that rule's logit difference (sampled_tie_check); drafts and
   verify dispatches above 0, a ragged launch a layer a verify forward,
   the acceptance rate printed. Then the composed verify
   (--no-ragged-kernel --no-ragged-dispatch: a prefill launch a layer a
   lane a verify forward) at
   batch 2, held to plain decode, and the CLI with
   --num-speculative-tokens 4 (log build/chip_smoke_spec_serve.log),
   whose /metrics carries both vllm:spec_decode_* counters;
9. checkpoint: the seeded llama-3.2-3b params (full width, CKPT_LAYERS =
   8 of its 28 layers, bf16) written as an HF checkpoint (one shard,
   2.4 GB) in a temporary directory
   under build/ that the phase removes, read back byte for byte (write
   and load seconds printed), then served by the CLI with --model <dir>
   --enable-lora --max-loras 4 --max-lora-rank 16 --num-scheduler-steps
   8; two PEFT adapters (rank 16 and 8, q/k/v/o) written by
   engine/lora.py are loaded over /v1/load_lora_adapter and listed by
   /v1/models; three short and three ~1100-token requests (base, each
   adapter) are sent at once, so prefill chunks and decode rows of
   different slots share ragged rounds (token ids read back through
   return_tokens_as_token_ids); launches held to 28 a forward; an
   unloaded adapter's name gets 404. In process on the same
   directory: one decode step with lanes [base, ad16, base, ad8] leaves
   the base lanes' logits bit-equal to the step without adapters; the
   base streams are held to an engine without LoRA and each adapter's
   to an engine on merged weights W + A @ B, under the near-tie rule
   (an adapter's tolerance is at least the LoRA vs merged forward's
   max|dlogit| over 256 rows);
10. KV (the 3B at full width and CKPT_LAYERS layers, a checkpoint its
   CLI engines serve): the port's cache server process (python -m
   production_stack_tpu_torch.kv.cache_server) starts; (a) an
   in-process bf16 engine prefills a 1500-token prompt and its
   46 full blocks (1 MiB each) are exported (gather on the compute
   stream, pinned d2h) and imported into 46 other blocks, three times,
   and read back byte-equal to each other, to a direct gather of the
   cache and through serialize/deserialize (export and import GB/s and
   the xxh64 microseconds a block printed); (b) the same engine, with a
   host-RAM tier of 24 blocks, a disk tier under build/ and the cache
   server written through, serves three other 1500-token prompts that
   evict the first from its 100-block pool, then restores all 46 blocks
   of it from the tiers (tpu:kv_restore_blocks), its greedy stream held
   to the cold one under the near-tie rule (cold and restored TTFT
   printed); (c) two CLI servers, prefill (--kv-role prefill
   --kv-transfer-listen) and decode (--kv-role kv_consumer --kv-peer),
   get an 1100-token prompt as the router's pd policy sends it (prefill
   with max_tokens 1, then decode): the decode server pulls 34 blocks
   and its stream is held to the prefill server's own for the same
   request; (d) a fresh engine with only the cache server restores the
   1500-token prompt from it. Restore and export fallbacks read 0
   throughout, launches 28 a forward on every engine and server;
11. phi-3: Phi-3-mini at full width, PHI3_SERVE_LAYERS of its 32 layers
   (seeded bf16 weights) written as an HF checkpoint under build/
   (removed after) and
   served by the CLI under auto (the gather path; log
   build/chip_smoke_phi3_serve.log): prompts of 24, 300, 900 and 3000
   tokens (the last past the 2047-token window) at once, 16 tokens
   each, no kernel launch;
11b. gemma: Gemma-7B at full width, GEMMA_SERVE_LAYERS of its 28
   layers (seeded bf16 weights) written as an HF checkpoint under build/
   (removed after) and served by the CLI under auto on the kernels (log
   build/chip_smoke_gemma_serve.log): prompts of 24, 300, 900 and 3000
   tokens at once, 16 tokens each, finish reason length, no xla warning
   in the log, mixed rounds run, launches one a layer a forward; the
   same
   requests on a --attention-impl xla server (log
   build/chip_smoke_gemma_xla_serve.log, no launch); the same prompts
   on one in-process runner on the checkpoint, the kernels against the
   gather path: float32 prefill and decode logits within
   GEMMA_F32_LOGIT_REL_TOL of max|logit|, and bf16's largest logit
   difference the near-tie bound the served streams are held to;
12. MoE: Mixtral-8x7B at its published widths, depth cut to 4 of 32
   layers (12.2 GB in bf16; the whole model does not fit one card): 2
   layers' logits card vs CPU; a 1-layer checkpoint with
   block_sparse_moe.* keys written and read back byte for byte; the
   dense MoE block's device time at batch 8 against its bytes bound;
   an engine on the default path serves the mixed phase's scenario with
   4 ragged launches a forward, in bf16 (its agreement with one-shot
   bf16 forwards of each whole sequence printed, beside how many
   (layer, token) expert pairs bf16 rounding alone moves between bf16
   and float32 one-shot forwards) and on the same weights in float32,
   whose greedy streams are held to one-shot float32 forwards under the
   near-tie rule;
13. tp: tensor parallelism on the one card: Llama-3.2-3B (full width,
   TP_LAYERS layers, bf16, seeded random weights) at tp=2, rank 0 in
   this process and
   rank 1 spawned (parallel/launch.start_tp_ranks with devices [cuda:0,
   cuda:0] and gloo: NCCL refuses two ranks on one device), beside a
   tp=1 engine on the same seed, both K=8: a one-shot 512-token
   forward's logits held to tp=1's (TP_LOGIT_REL_TOL, printed); the
   mixed phase's scenario (four greedy 32-token requests, a 1500-token
   prompt at step 2) with streams held to tp=1's under the near-tie
   rule; each rank's launches (read from the followers through the
   step broadcast) held to one a layer a forward, its params and KV
   cache on
   the card and no collective on a host tensor; wall ms a token at
   batch 8 in turns, printed as gloo on one shared card (not a TP
   speed); then the Qwen2-7B 2-layer checkpoint (the families phase's
   config: qkv bias split, untied lm_head vocab-sharded, each rank
   loading its shard) at tp=2, logits held to tp=1's. A follower that
   fails, or exits with another code than 0, fails the run;
14. long context (parallel/ring_attention.py, parallel/long_context.py,
   engine/long_prefill.py; every rank of a ring on the one card, which
   its ranks share, so no time here is an sp speed): (a) the ring
   (ring_attention_local on each of sp=2 and sp=4 ranks) against a
   float32 oracle built apart from the port's grouping helpers (K/V
   repeated to the q heads) on the card at 8192 rows, the 3B's heads
   (24 q over 8 kv, d 128) causal and Mistral-7B's (32 over 8) with its
   4096-token window, bf16 and f32 on the same inputs, held per (row,
   head) to LC_BF16_REL_TOL / LC_F32_REL_TOL, ms printed (float32
   products, TF32 off); (b) LongContextPrefiller.prefill of a
   4096-token prompt at sp=2 on the 28-layer 3B (seeded bf16 params,
   used without a copy) against chunked prefill of the same prompt on
   the prefill kernel: last-row logits within DECODE_LOGIT_REL_TOL of
   max|logit|, K/V rows within LC_KV_REL_TOL, no kernel launched by the
   ring; (c) an engine of the 3B at TP_LAYERS layers with
   long_prefill_threshold 4096, context_parallel_size 2 and
   long_prefill_chunk 2048 and the same engine without the lane, on
   the same seed, each serving four greedy
   64-token requests with a ~16000-token prompt arriving at step 12:
   the lane serves it in 8 ring chunks (S_pad 16384) with 0 fallbacks,
   ring / d2h / land seconds > 0, ring devices on the card, no
   'DISABLED' or 'failed' lane warning and one shared-card warning,
   decode rounds while the ring is in flight, TP_LAYERS ragged
   launches a forward over the run and over the decode after landing
   (the ring launches none), streams held to the control's under the
   near-tie rule; TTFT ring and chunked, the step-thread host ms of
   each chunk's dispatch, the decoders' ITL with and without a ring in
   flight and the memory peak printed; (d) the CLI with
   --long-prefill-threshold 4096 --context-parallel-size 2 (log
   build/chip_smoke_lc_serve.log): /v1/models carries sp_size 2, a
   5000-token completion is answered, /metrics counts one long-prefill
   request and no fallback, launches 28 a forward.
15. Pipeline parallelism (pp_phase): the 3B (TP_LAYERS layers) served
   at pp=2 (two ranks) and at pp=2 x tp=2 (four ranks), every rank on
   cuda:0 over gloo, each rank set started once, against one pp=1
   engine on the gather path (attention_impl xla) on the same seed: a
   one-shot 512-token forward's logits within PP_LOGIT_REL_TOL of
   max|logit|, the mixed scenario's streams under the near-tie rule,
   every rank's report (stage and tp index by the row-major layout,
   half the layers, no kernel launch: pp serves on the gather path as JAX serves it on XLA, the
   store steps rank 0 published), wall ms a token at batch 8 in turns
   (ranks share one card over gloo: not a PP speed); then
   PipelinedPrefiller on a 4096-token prompt, 2 stages of 2 layers on
   the card: all rows' logits and every K/V row held to a one-shot
   forward.
16. Multihost (multihost_phase): two processes of the CLI joined into
   one job on loopback (--multihost --num-processes 2 --process-id
   {0,1} --coordinator-address 127.0.0.1:<port>
   --tensor-parallel-size 2; logs build/chip_smoke_mh{0,1}_serve.log),
   each one rank on cuda:0 over gloo, serving the 3B at full width and
   TP_LAYERS layers from a checkpoint the phase writes: process 0
   serves, process 1 follows; a greedy completion held to an in-process
   tp=1 engine's on that checkpoint under the near-tie rule, rank 0's
   launches TP_LAYERS a forward,
   and after SIGTERM to process 0 (a graceful stop: its shutdown stops
   the rank set's followers) both processes exit 0 within MH_EXIT_S,
   process 1 on the shutdown step.
17. Rank-set features (rank_set_phase): the 3B (TP_LAYERS layers) at
   tp=2 (both ranks on cuda:0 over gloo) beside a tp=1 engine, with two rank-8 adapters
   (buffers a rank, one-shot logits of each lane, streams), the KV
   phase's 46-block export and import (every rank's slice byte-equal
   to its cut of the wire), evict and restore through the CPU tier, a
   PD pull into a tp=1 decode engine; then Mixtral-8x7B x4 float32 at
   tp=2 against tp=1, block by block and on the logits, beside a
   bfloat16 control, 4 experts a rank.
18. Rank-set serving (rank_set_serving_phase): the 3B at TP_LAYERS
   layers and tp=2 (both ranks on cuda:0 over gloo): (f) a K=8 engine at
   max_model_len 256 runs precompile_serving on every rank (grid and
   count against
   expected_sweep, the ranks' dispatches equal, the sweep's seconds);
   (e) a K=8 --async-decode engine beside it on the tp phase's mixed
   scenario (streams under the near-tie rule, chained rounds and token
   checks on every rank, one ragged launch a layer a forward a rank)
   and batch
   8 in turns; (g) the long-context phase's lane scenario at tp=2 x
   sp=2 beside a chunked tp=2 control (streams, first-token logits
   against the tp=1 lane's, chunks, fallbacks, blocks landed, TTFT, the
   collect's seconds, the decoders' ITL).
19. Stack (stack_phase): the whole port stack, each process started as a
   user starts it: a KV controller (python -m
   production_stack_tpu_torch.kv.controller), four CLI engines of the
   3B at full width and CKPT_LAYERS layers (a checkpoint; two both-role
   with 512 KV blocks reporting to the
   controller, a prefill-role and a decode-role PD pair) and, in turn,
   the port's router (python -m production_stack_tpu_torch.router) in
   front of them under each routing algorithm: roundrobin (8 greedy
   streams, completions and chats, split 4 and 4 by the engines'
   /metrics), session (8 requests of one x-user-id on one engine),
   prefixaware and kvaware (8 requests sharing a 1500-char prefix, all
   on the first request's engine, its prefix-cache hits up and the
   other's not), ttft and latency, every stream held to the same
   request sent straight to an engine under the near-tie rule and the
   router's request counts (read with the port's Prometheus parser)
   equal to the engines'; TTFT through the router against direct (p50
   and p90 of 16 streams, the router's first event well before its
   last), the router's boot seconds and its hashing µs a prefixaware
   request; pd and disaggregated_prefill over the PD pair (an
   1100-token prompt's prefill on the prefill engine, one 34-block
   chain pull into the decode engine, no fallback, the stream held to a
   both-role engine's); each engine's launches 28 a forward; then one
   both-role engine SIGTERMed under a steady load behind a roundrobin
   router with static health checks: no client error, and once the
   router drops it from discovery every request goes to the survivor.
   Logs build/chip_smoke_stack_*.log.

Launch counts are reset just before the serve phase's requests (through
the server's /debug/kernel_launches) and again before its API requests,
before each guided-phase engine, before the decode phase's
--no-ragged-kernel engine, before each pipeline-phase engine and before
each mixed-round engine, before each compiled-phase, sync-phase and
async-phase engine's run, before each spec-phase engine's run and the
spec server's requests, before the checkpoint phase's requests,
before each families-phase engine and each Gemma-7B server's requests,
before each KV-phase engine's and server's requests, before each
impl-phase turn, the gather families' engines, the Phi-3 server's
requests, the Mixtral engine's run and, on every rank, before the tp
phase's one-shot forwards and its tp=2 scenario, before each
long-context engine's run and the long-context server's request, on
every rank before each pp scenario, before the multi-host
server's completion, on every rank before each rank-set run and
before each rank-set serving run, on each stack-phase engine before
the router's first request, and read just after; a kernel launched 0
times on those paths fails the run. The servers' logs go to build/chip_smoke_serve.log,
build/chip_smoke_lc_serve.log,
build/chip_smoke_spec_serve.log, build/chip_smoke_lora_serve.log, build/chip_smoke_prefill_serve.log,
build/chip_smoke_decode_serve.log, build/chip_smoke_cache_server.log and
build/chip_smoke_phi3_serve.log, build/chip_smoke_gemma{,_xla}_serve.log,
build/chip_smoke_mh{0,1}_serve.log and
build/chip_smoke_stack_*.log.
The last lines are the kernels JSON, the
card's name and power limit (nvidia-smi), and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
# kernel vs plain, per (row, head): |out - ref| <= TOL * max|ref| over d.
# bf16: the plain versions and the kernels round one f32 result once, so
# they differ by at most one bf16 step (<= 2^-7 of the row's largest
# value); the kernels also round P to bf16 (relative 2^-9 per weight) for
# the tensor-core PV product, which moves a row by a fraction of a step
# more. 2^-6 is two steps.
# f32: summation order only; a row that saw one key too many or too few
# moves by ~1e-3 of its largest value at these context lengths.
BF16_REL_TOL = 2.0**-6
F32_REL_TOL = 1e-4
LOGIT_REL_TOL = 5e-2       # forward, max|dlogit| / max|logit|, bf16
# decode phase: the same 28-layer bf16 decode step on two kernels that
# differ in summation order (both round P to bf16 for the tensor-core PV
# product), max|dlogit| / max|logit|: sound runs read 1.5e-2 to 1.6e-2,
# the same step with the last split of the longest lane skipped reads
# 0.35 (on an H100); the bound is about twice the sound reading, and the
# faulty step must land above it in every run
DECODE_LOGIT_REL_TOL = 3e-2
LAYERS_3B = 28
# the prompt that arrives while other requests decode: three 512-token
# chunks at the engine's default max_prefill_chunk
LONG_PROMPT_TOKENS = 1500
# the depth of the 3B in the tp, long-context engine, pp, multi-host and
# rank-set serving phases: every rank of a set shares the one card over
# gloo, so an eager forward's host time grows with its layers'
# collectives (a 28-layer tp=2 decode token took 14-20 ms against 0.9 ms
# at tp=1 on an H100), and these phases check the rank sets' plumbing,
# which every layer repeats; the serve phase keeps all 28
TP_LAYERS = 4


def cut_3b() -> str:
    """Register Llama-3.2-3B at its full width and TP_LAYERS layers as a
    preset of this process (start_tp_ranks hands the resolved config to
    the ranks it spawns) and return its name."""
    import dataclasses

    from production_stack_tpu_torch.models import config as mconfig

    cut = dataclasses.replace(mconfig.get_model_config("llama-3.2-3b"),
                              name=f"llama-3.2-3b-x{TP_LAYERS}",
                              num_layers=TP_LAYERS)
    mconfig._PRESETS[cut.name] = cut
    return cut.name


@contextlib.contextmanager
def cut_3b_checkpoint(torch, layers: int, prefix: str):
    """Llama-3.2-3B at full width and `layers` layers (seeded random
    bf16 params) as an HF checkpoint in a temporary directory under
    build/, removed on exit: yields its directory, which a CLI engine
    serves with --model (the CLI takes no run-time preset)."""
    import dataclasses
    import shutil
    import tempfile

    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.models.debug_checkpoint import (
        hf_config_of,
        write_hf_checkpoint,
    )

    cfg = dataclasses.replace(get_model_config("llama-3.2-3b"),
                              num_layers=layers)
    (REPO / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix=prefix, dir=REPO / "build"))
    try:
        ckdir = str(root / "llama-3.2-3b")
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        write_hf_checkpoint(ckdir, hf_config_of(cfg), llama.init_params(
            cfg, gen, torch.bfloat16, "cuda"))
        release(torch)
        print(f"{prefix}checkpoint: the 3B at {layers} layers written in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
        yield ckdir
    finally:
        shutil.rmtree(root, ignore_errors=True)


def release(torch) -> None:
    """Free the memory of engines a phase dropped: a runner holding
    compiled programs is part of a reference cycle (its variants' code
    refers to it), so it goes at a collection, not at `del`."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list[str]:
    """Registers and spills per kernel instantiation from a -Xptxas -v
    log."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.strip()}")
    return out


# -- timing --------------------------------------------------------------------
def time_cuda(torch, fn, iters: int, flush) -> float:
    """Mean ms per call over `iters` calls, each with a cold L2 (a 256 MB
    write between calls) and timed alone with CUDA events."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    evs = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    for a, b in evs:
        total += a.elapsed_time(b)
    return total / iters


def device_breakdown(torch, fn, flush, names, n: int = 10) -> str:
    """Device time per call of each CUDA kernel whose name holds one of
    `names`, from torch.profiler over n calls, each after the 256 MB
    write that time_cuda flushes the L2 with ("not measured" where the
    profiler records no device time); beside it the host's time to
    enqueue one call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    parts = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        hit = [k for k in names if k in ev.key]
        if hit and dev_us:
            parts.append(f"{hit[0]} {dev_us / n:.1f} us")
    return (f"device {', '.join(parts) if parts else 'not measured'}; "
            f"host enqueue {host_us:.1f} us/call")


# -- kernel phase --------------------------------------------------------------
# attention shapes of the kernel phase's runs beyond the 3B's: (layers,
# query heads, kv heads, head_dim) of google/gemma-7b and google/gemma-2b
GEMMA_KERNEL_SHAPES = {"Gemma-7B": (28, 16, 16, 256),
                       "Gemma-2B": (18, 8, 1, 256)}


def kernel_phase(torch, model: str = "",
                 shape: tuple = (28, 24, 8, 128)) -> list[tuple[str, dict]]:
    """The kernels against their plain versions and timed at one model's
    attention shape (layers, nq, nkv, head_dim), the 3B's by default;
    `model` names another in every printed line."""
    import numpy as np
    import torch.nn.functional as F

    from production_stack_tpu_torch.ops import paged_attention as pa

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    L, nq, nkv, d = shape
    bs = 32
    g = nq // nkv
    num_blocks = 2560  # 81920 slots: offsets of the 3B's layer 27 pass 2^31
    slots = num_blocks * bs
    layer = L - 1
    scale = d**-0.5
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k_cache = torch.randn((L, nkv, slots, d), generator=gen, device=dev,
                          dtype=dt)
    v_cache = torch.randn((L, nkv, slots, d), generator=gen, device=dev,
                          dtype=dt)
    assert model or (layer * nkv + nkv - 1) * slots * d > 2**31
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    tag = f"[{model}: nq {nq}, nkv {nkv}, d {d}] " if model else ""

    # lanes: 8 decode lanes (page-straddling contexts) + 2 prefill chunks
    dec_ctx = [1, 31, 32, 33, 500, 1000, 1531, 2047]
    pf = [(0, 256), (700, 384)]  # (q_start, rows)
    lanes_ctx = dec_ctx + [qs + n for qs, n in pf]
    P = max(-(-c // bs) for c in lanes_ctx)
    perm = rng.permutation(num_blocks)
    tables = np.zeros((len(lanes_ctx), P), np.int32)
    for i in range(len(lanes_ctx)):
        tables[i] = perm[i * P:(i + 1) * P]
    tables_d = torch.from_numpy(tables).to(dev)

    # ragged row space: block 0 holds the 8 decode rows (+ an idle
    # segment), then each prefill chunk's tq-blocks
    tq = pa.RAGGED_TQ
    blk_seg, seg_meta = [0], []
    for i, c in enumerate(dec_ctx):
        seg_meta.append([i, i, 1, c - 1])
    seg_meta.append([0, 0, 0, 5])  # idle segment: stores nothing
    blk_seg.append(len(seg_meta))
    for j, (qs, n) in enumerate(pf):
        for r0 in range(0, n, tq):
            seg_meta.append([len(dec_ctx) + j, 0, tq, qs + r0])
            blk_seg.append(len(seg_meta))
    G = len(blk_seg) - 1
    R = G * tq
    q_r = torch.randn((R, nq, d), generator=gen, device=dev, dtype=dt)
    blk_seg_d = torch.tensor(blk_seg, dtype=torch.int32, device=dev)
    seg_meta_d = torch.tensor(seg_meta, dtype=torch.int32, device=dev)
    covered = [i for i in range(len(dec_ctx))] + list(range(tq, R))

    def padded_decode_sdpa_inputs(rows_q, qpos, tables):
        """One SDPA of each decode lane's row, (b, nq, 1, d), over its
        own context padded to the table width, (b, nq, P * bs, d) with
        K/V repeated over the g query heads, under a boolean visibility
        mask: for decode the fastest library call tried (one call over
        the lanes' contexts end to end, as for ragged, took twice as
        long)."""
        C = tables.shape[1] * bs
        slots_l = (tables.long()[:, :, None] * bs
                   + torch.arange(bs, device=dev)).reshape(len(qpos), C)
        k = k_cache[layer][:, slots_l].permute(1, 0, 2, 3)
        v = v_cache[layer][:, slots_l].permute(1, 0, 2, 3)
        mask = (torch.arange(C, device=dev)[None, :]
                <= torch.tensor(qpos, device=dev)[:, None])
        k = k.repeat_interleave(g, dim=1).contiguous()
        v = v.repeat_interleave(g, dim=1).contiguous()
        return (rows_q[:, :, None, :].contiguous(), k, v,
                mask[:, None, None, :].contiguous(), False)

    def fair_sdpa_inputs(rows_q, qpos, lane_of_row, tables):
        """One SDPA call that reads each lane's context once: the rows
        (1, nq, R, d) over the lanes' contexts (positions 0 .. the lane's
        last row) laid end to end, (1, nkv, sum ctx, d), GQA through
        enable_gqa, under a block-causal mask (a row sees its own lane's
        keys up to its position)."""
        lane_t = torch.tensor(lane_of_row, device=dev)
        qp = torch.tensor(qpos, device=dev)
        kslots, klane, kpos = [], [], []
        for lane in sorted(set(lane_of_row)):
            n = max(q for q, ln in zip(qpos, lane_of_row) if ln == lane) + 1
            pos = torch.arange(n, device=dev)
            kslots.append(tables[lane].long()[pos // bs] * bs + pos % bs)
            klane.append(torch.full_like(pos, lane))
            kpos.append(pos)
        sl = torch.cat(kslots)
        kl, kp = torch.cat(klane), torch.cat(kpos)
        mask = (kl[None, :] == lane_t[:, None]) & (kp[None, :] <= qp[:, None])
        return (rows_q.transpose(0, 1)[None].contiguous(),
                k_cache[layer][:, sl][None].contiguous(),
                v_cache[layer][:, sl][None].contiguous(),
                mask[None, None].contiguous(), True)

    def visible_keys(qpos):
        return sum(p + 1 for p in qpos)

    def bound(n_rows, qpos, kv_tokens):
        kv_bytes = 2 * kv_tokens * nkv * d * 2
        qo_bytes = 2 * n_rows * nq * d * 2
        ops = 4 * visible_keys(qpos) * nq * d
        t_bytes = (kv_bytes + qo_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = ops / BF16_FLOPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                              "operations")

    def compare(name, out_k, out_p, rows_sel, rel_tol):
        """Max abs error of the kernel against the plain version over the
        covered rows, held per (row, head) to rel_tol * max|ref|."""
        torch.cuda.synchronize()
        o = out_k[rows_sel].float()
        r = out_p[rows_sel].float()
        err = (o - r).abs()
        tol = rel_tol * r.abs().amax(dim=-1, keepdim=True)
        worst = float((err / tol.clamp_min(1e-30)).max())
        max_err = float(err.max())
        print(f"kernel {tag}{name}: max_abs_err={max_err:.3e} worst "
              f"err/tol={worst:.3f} (tol {rel_tol:.3g} x max|ref| per row, "
              "head)", flush=True)
        if not worst <= 1.0:
            fail(f"{tag}{name}: kernel vs plain off by {worst:.3f}x the "
                 "tolerance")
        return max_err

    # f32 copies of the layer the checks read, at the same slots: the
    # same inputs through kernel and plain version with f32 arithmetic
    # only, where a masking or page-range fault cannot hide in rounding
    k32 = k_cache[layer:layer + 1].float()
    v32 = v_cache[layer:layer + 1].float()

    def sdpa_ms(args):
        q4, k4, v4, m4, gqa = args
        kw_gqa = {"enable_gqa": True} if gqa else {}
        return time_cuda(
            torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, scale=scale, **kw_gqa),
            20, flush)

    def check(name, kern, plain, rows_sel, lib_args, n_rows, qpos,
              kv_tokens, f32_args, cuda_names, iters=20):
        err = compare(f"{name} bf16", kern(), plain(), rows_sel,
                      BF16_REL_TOL)
        kern32, plain32 = f32_args
        compare(f"{name} f32", kern32(), plain32(), rows_sel, F32_REL_TOL)
        ms = time_cuda(torch, kern, iters, flush)
        split = device_breakdown(torch, kern, flush, cuda_names)
        plain_ms = time_cuda(torch, plain, 3, flush)
        lib_ms = sdpa_ms(lib_args())
        release(torch)
        bms, by = bound(n_rows, qpos, kv_tokens)
        print(f"kernel {tag}{name}: kernel_ms={ms:.4f} (mean of {iters}; "
              f"profiler, per call: {split}) plain_ms={plain_ms:.3f} "
              f"bound_ms={bms:.4f} ({by}) library_ms={lib_ms:.4f}",
              flush=True)
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}

    def report(name, st, grid, smem, rate):
        """Grid, shared memory, achieved rate and roofline share of a
        redesigned kernel (registers and spills: the build phase's
        ptxas lines)."""
        print(f"kernel {tag}{name}: grid {grid}, dynamic shared memory "
              f"{smem} bytes, {rate}, bound/kernel = "
              f"{st['bound_ms'] / st['ms']:.3f}", flush=True)

    kw = dict(block_size=bs, scale=scale)
    # ragged: the decode rows + prefill chunks mix, full context
    qpos_r, lane_r = [], []
    for r in covered:
        if r < tq:
            qpos_r.append(dec_ctx[r] - 1)
            lane_r.append(r)
        else:
            lane = len(dec_ctx) + (0 if r < tq + pf[0][1] else 1)
            base = tq if lane == len(dec_ctx) else tq + pf[0][1]
            qpos_r.append(pf[lane - len(dec_ctx)][0] + r - base)
            lane_r.append(lane)
    kv_tok = sum(lanes_ctx)
    rows_t = torch.tensor(covered, device=dev)
    q_r32 = q_r.float()

    def ragged(fn, qq, kk, vv, ll, window=None):
        return lambda: fn(qq, kk, vv, ll, tables_d, blk_seg_d, seg_meta_d,
                          window=window, **kw)

    rag = check(
        "ragged_paged_attention",
        ragged(pa.ragged_paged_attention, q_r, k_cache, v_cache, layer),
        ragged(pa.ragged_paged_attention_plain, q_r, k_cache, v_cache,
               layer),
        rows_t,
        lambda: fair_sdpa_inputs(q_r[rows_t], qpos_r, lane_r, tables_d),
        len(covered), qpos_r, kv_tok,
        (ragged(pa.ragged_paged_attention, q_r32, k32, v32, 0),
         ragged(pa.ragged_paged_attention_plain, q_r32, k32, v32, 0)),
        ("ragged_tile_kernel",),
    )
    # one windowed case on the same mix (kernel vs plain only)
    w = 256
    werr = compare(
        f"ragged_paged_attention window={w} bf16",
        ragged(pa.ragged_paged_attention, q_r, k_cache, v_cache, layer,
               w)(),
        ragged(pa.ragged_paged_attention_plain, q_r, k_cache, v_cache,
               layer, w)(),
        rows_t, BF16_REL_TOL)
    compare(
        f"ragged_paged_attention window={w} f32",
        ragged(pa.ragged_paged_attention, q_r32, k32, v32, 0, w)(),
        ragged(pa.ragged_paged_attention_plain, q_r32, k32, v32, 0, w)(),
        rows_t, F32_REL_TOL)
    rag["max_abs_err"] = max(rag["max_abs_err"], werr)
    smem = pa._prefill_smem(d, 2, 2)  # the prefill tile: ragged too
    bn = pa._key_tile(d, 2, 2)
    n_x, n_y = pa._ragged_grid(len(seg_meta), tq, g, nkv)
    rag_bytes = 2 * kv_tok * nkv * d * 2 + 2 * len(covered) * nq * d * 2
    report("ragged_paged_attention", rag,
           f"({n_x}, {n_y}) = {n_x * n_y} blocks, one per (segment, "
           f"{pa.PREFILL_BM}-fused-row tile, kv head), "
           f"{bn}-key tiles", smem,
           f"{rag_bytes / rag['ms'] / 1e6:.1f} GB/s, "
           f"{4 * visible_keys(qpos_r) * nq * d / rag['ms'] / 1e9:.1f} "
           "TFLOP/s (bf16)")

    # prefill: one 512-row chunk at q_start 1024 over 48 shuffled pages;
    # the kernel reads its start from device memory (as a captured
    # prefill program hands it), the plain version takes the same tensor
    t, qs = 512, 1024
    qs_dev = torch.tensor([qs], dtype=torch.int32, device=dev)
    n_pf = -(-(qs + t) // bs)
    pf_table = torch.from_numpy(perm[:n_pf].astype(np.int32)).to(dev)
    q_p = torch.randn((t, nq, d), generator=gen, device=dev, dtype=dt)
    qpos_p = [qs + i for i in range(t)]

    q_p32 = q_p.float()
    pre = check(
        "paged_prefill_attention",
        lambda: pa.paged_prefill_attention(
            q_p, k_cache, v_cache, layer, pf_table, qs_dev, **kw),
        lambda: pa.paged_prefill_attention_plain(
            q_p, k_cache, v_cache, layer, pf_table, qs_dev, **kw),
        torch.arange(t, device=dev),
        lambda: fair_sdpa_inputs(q_p, qpos_p, [0] * t, pf_table[None]),
        t, qpos_p, qs + t,
        (lambda: pa.paged_prefill_attention(
            q_p32, k32, v32, 0, pf_table, qs_dev, **kw),
         lambda: pa.paged_prefill_attention_plain(
            q_p32, k32, v32, 0, pf_table, qs_dev, **kw)),
        ("prefill_kernel",),
    )

    n_tiles = -(-t * g // pa.PREFILL_BM)
    report("paged_prefill_attention", pre,
           f"({n_tiles}, {nkv}) = {n_tiles * nkv} blocks of "
           f"{pa.PREFILL_BM} fused rows x {bn}-key tiles",
           smem,
           f"{4 * visible_keys(qpos_p) * nq * d / pre['ms'] / 1e9:.1f} "
           f"TFLOP/s (bf16)")

    # decode: the 8 decode lanes
    b = len(dec_ctx)
    q_d = torch.randn((b, nq, d), generator=gen, device=dev, dtype=dt)
    ctx_d = torch.tensor(dec_ctx, dtype=torch.int32, device=dev)
    tab_d = tables_d[:b].contiguous()
    qpos_d = [c - 1 for c in dec_ctx]
    q_d32 = q_d.float()
    dec = check(
        "paged_decode_attention",
        lambda: pa.paged_decode_attention(
            q_d, k_cache, v_cache, layer, tab_d, ctx_d, **kw),
        lambda: pa.paged_decode_attention_plain(
            q_d, k_cache, v_cache, layer, tab_d, ctx_d, **kw),
        torch.arange(b, device=dev),
        lambda: padded_decode_sdpa_inputs(q_d, qpos_d, tab_d),
        b, qpos_d, sum(dec_ctx),
        (lambda: pa.paged_decode_attention(
            q_d32, k32, v32, 0, tab_d, ctx_d, **kw),
         lambda: pa.paged_decode_attention_plain(
            q_d32, k32, v32, 0, tab_d, ctx_d, **kw)),
        ("decode_split_kernel", "decode_merge_kernel"),
    )
    pps, n_splits = pa._decode_split_plan(P, bs)
    kv_bytes = 2 * sum(dec_ctx) * nkv * d * 2 + 2 * b * nq * d * 2
    report("paged_decode_attention", dec,
           f"({b}, {nkv}, {n_splits}) = {b * nkv * n_splits} blocks "
           f"({n_splits} splits of {pps} pages) + merge ({b}, {nkv})",
           pa._decode_smem(g, d, 2, 2),
           f"{kv_bytes / dec['ms'] / 1e6:.1f} GB/s")

    # the ragged kernel on the same decode lanes alone, packed as the
    # model runner packs a decode step (one single-row segment a lane):
    # the launch the serving engine makes most
    from production_stack_tpu_torch.engine.model_runner import (
        decode_segments,
    )
    r_pad, dblk, dmeta = decode_segments(np.asarray(dec_ctx, np.int32))
    assert r_pad == b
    dblk_d = torch.from_numpy(dblk).to(dev)
    dmeta_d = torch.from_numpy(dmeta).to(dev)

    def ragged_dec(fn, qq, kk, vv, ll):
        return lambda: fn(qq, kk, vv, ll, tab_d, dblk_d, dmeta_d, **kw)

    rdec = check(
        "ragged_paged_attention decode-only",
        ragged_dec(pa.ragged_paged_attention, q_d, k_cache, v_cache, layer),
        ragged_dec(pa.ragged_paged_attention_plain, q_d, k_cache, v_cache,
                   layer),
        torch.arange(b, device=dev),
        lambda: padded_decode_sdpa_inputs(q_d, qpos_d, tab_d),
        b, qpos_d, sum(dec_ctx),
        (ragged_dec(pa.ragged_paged_attention, q_d32, k32, v32, 0),
         ragged_dec(pa.ragged_paged_attention_plain, q_d32, k32, v32, 0)),
        ("ragged_tile_kernel",),
    )
    n_x, n_y = pa._ragged_grid(len(dmeta), tq, g, nkv)
    report("ragged_paged_attention decode-only", rdec,
           f"({n_x}, {n_y}) = {n_x * n_y} blocks", smem,
           f"{kv_bytes / rdec['ms'] / 1e6:.1f} GB/s")
    print(f"{tag}decode lanes ({b}, contexts {dec_ctx}): "
          f"ragged_paged_attention kernel_ms={rdec['ms']:.4f} beside "
          f"paged_decode_attention kernel_ms={dec['ms']:.4f} "
          f"(x{rdec['ms'] / dec['ms']:.2f})", flush=True)
    del k_cache, v_cache, k32, v32, flush
    release(torch)
    print(f"kernel phase {tag}{time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return [("ragged", rag), ("prefill", pre), ("decode", dec)]


# -- forward phase -------------------------------------------------------------
def two_step_logits(torch, pa, cfg, params, dev, gather=False):
    """Logits of a 40-token prompt's last row (one 64-row prefill chunk on
    paged_prefill_attention) and of one decode step after it (a
    single-row segment on ragged_paged_attention), through
    models/llama.forward on `dev`'s params; (2, vocab) f32 on the CPU.
    `gather`: both steps on the gather path (ops/attention.py, the xla
    attention impl) instead of the kernels."""
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.ops import attention

    bs, n_blocks = 32, 16
    scale = cfg.head_dim**-0.5
    t, first = 64, 40  # a 40-token prompt padded to a 64-row chunk
    shape = (cfg.num_layers, cfg.num_kv_heads, n_blocks * bs, cfg.head_dim)
    kc = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    table = torch.arange(1, 4, dtype=torch.int32, device=dev)
    toks = torch.arange(t, device=dev) * 37 % cfg.vocab_size
    pos = torch.arange(t, device=dev)
    pos[first:] = 0
    slots = torch.arange(t, device=dev) + bs
    slots[first:] = 0

    def attn_pf(q, l, k, v):
        fn = (attention.paged_prefill_attention_gather if gather
              else pa.paged_prefill_attention)
        return fn(q, k, v, l, table, 0, block_size=bs, scale=scale,
                  window=cfg.sliding_window)

    lg1, _, _ = llama.forward(
        cfg, params, toks, pos, kc, vc, slots, attn_pf,
        logits_rows=torch.tensor([first - 1], device=dev))
    blk = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    meta = torch.tensor([[0, 0, 1, first]], dtype=torch.int32, device=dev)

    def attn_dec(q, l, k, v):
        if gather:
            return attention.paged_decode_attention_gather(
                q, k, v, l, table[None, :],
                torch.tensor([first + 1], device=dev), block_size=bs,
                scale=scale, window=cfg.sliding_window)
        qp = torch.zeros((8,) + tuple(q.shape[1:]), dtype=q.dtype,
                         device=dev)
        qp[:1] = q
        return pa.ragged_paged_attention(
            qp, k, v, l, table[None, :], blk, meta, block_size=bs,
            scale=scale, window=cfg.sliding_window)[:1]

    lg2, _, _ = llama.forward(
        cfg, params, torch.tensor([5], device=dev),
        torch.tensor([first], device=dev), kc, vc,
        torch.tensor([bs + first], device=dev), attn_dec,
        logits_rows=torch.tensor([0], device=dev))
    return torch.cat([lg1, lg2]).float().cpu()


def tree_to(tree, dev):
    return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def card_vs_cpu(torch, pa, what, cfg, params_gpu, gather=False) -> float:
    """two_step_logits on the card (kernels, or the gather path) against
    the CPU (plain versions, or the gather path) on the same params;
    fails above LOGIT_REL_TOL."""
    ref = two_step_logits(torch, pa, cfg, tree_to(params_gpu, "cpu"), "cpu",
                          gather)
    got = two_step_logits(torch, pa, cfg, params_gpu, "cuda", gather)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite logits on the card")
    rel = float((got - ref).abs().max() / ref.abs().max())
    print(f"{what}: logits {tuple(got.shape)} card vs CPU "
          f"max|d|/max|ref|={rel:.3e} tol={LOGIT_REL_TOL}", flush=True)
    if not rel <= LOGIT_REL_TOL:
        fail(f"{what}: relative logit error {rel} > {LOGIT_REL_TOL}")
    return rel


def forward_phase(torch) -> None:
    import dataclasses

    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.ops import paged_attention as pa

    cfg = dataclasses.replace(get_model_config("llama-3.2-3b"),
                              num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
    card_vs_cpu(torch, pa, "forward llama-3.2-3b x2 layers bf16", cfg,
                params)
    del params
    release(torch)


# -- serve phase ---------------------------------------------------------------
def http(port: int, path: str, body: dict | None = None,
         timeout: float = 600.0, method: str | None = None
         ) -> tuple[int, str]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"}, method=method,
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def sse_stream(port: int, body: dict, timeout: float = 600.0,
               started=None) -> dict:
    """One streamed completion read to its end: its data events, the
    last one's finish_reason, whether the stream closed with [DONE], and
    the host-clock times (time.perf_counter) its response head, last
    data event and [DONE] arrived. `started` (a threading.Event) is set
    once the head has arrived."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    out = {"events": 0, "finish": None, "done": False, "t_head": None,
           "t_last_event": None, "t_done": None}
    with urllib.request.urlopen(req, timeout=timeout) as r:
        out["t_head"] = time.perf_counter()
        if started is not None:
            started.set()
        for raw in r:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                out["done"], out["t_done"] = True, time.perf_counter()
                break
            if line.startswith("data:"):
                out["events"] += 1
                out["t_last_event"] = time.perf_counter()
                out["finish"] = json.loads(line[5:])["choices"][0][
                    "finish_reason"]
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_server(port: int, log_path: Path, model: str = "llama-3.2-3b",
                 extra: tuple = ()) -> subprocess.Popen:
    """The port's CLI in a child process, as a user starts it."""
    cmd = [
        sys.executable, "-m", "production_stack_tpu_torch.engine",
        "--model", model, "--tokenizer", "byte",
        "--block-size", "32", "--num-kv-blocks", "1024",
        "--max-num-seqs", "8", "--seed", str(SEED),
        "--host", "127.0.0.1", "--port", str(port), *extra,
    ]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    print(f"serve: {' '.join(cmd[1:])}", flush=True)
    log_path.parent.mkdir(parents=True, exist_ok=True)
    with open(log_path, "wb") as log:
        return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def stop_server(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(60)


def log_tail(log_path: Path, n: int = 40) -> str:
    return "\n".join(log_path.read_text(errors="replace").splitlines()[-n:])


def metric(port: int, name: str) -> float:
    """One sample of the server's /metrics text (the first with `name`)."""
    samples, _ = parse_metrics(http(port, "/metrics")[1])
    if name not in samples:
        fail(f"/metrics has no {name}")
    return samples[name][0][1]


def parse_metrics(text: str) -> tuple[dict, dict]:
    """Prometheus text exposition -> ({sample name: [(labels, value)]},
    {family: type}), read with the port's parser (utils/prometheus.py:
    the card's machine has no prometheus_client); a counter family is
    named as its TYPE line names it, with its _total."""
    from production_stack_tpu_torch.utils.prometheus import (
        text_string_to_metric_families,
    )

    samples: dict[str, list] = {}
    types: dict[str, str] = {}
    for fam in text_string_to_metric_families(text):
        total = "_total" if fam.type == "counter" else ""
        types[fam.name + total] = fam.type
        for s in fam.samples:
            samples.setdefault(s.name, []).append((s.labels,
                                                   float(s.value)))
    return samples, types


# the families the router parses (router/stats/engine_stats.py)
ROUTER_FAMILIES = {
    "vllm:gpu_prefix_cache_hit_rate": "gauge",
    "vllm:gpu_prefix_cache_hits_total": "gauge",
    "vllm:gpu_prefix_cache_queries_total": "gauge",
    "tpu:scheduling_delay_seconds": "histogram",
}


def check_launches(what: str, launches: dict, dispatches: dict,
                   layers: int = LAYERS_3B, impl: str = "ragged") -> None:
    """impl "ragged" (the default config): every ragged-kernel forward
    launches it once a layer (packed and single-step decode forwards,
    each iteration of a fused loop, each mixed round's step-0 forward,
    each speculative verify forward), the prefill kernel once a layer
    per single-sequence prefill. "composed" (--no-ragged-kernel): the
    prefill kernel once a layer per single-sequence prefill and per
    padded lane of a packed forward (runner prefill_lanes), the decode
    kernel once a layer per decode forward and fused-loop iteration, the
    ragged kernel never. "xla": no kernel at all."""
    if impl == "ragged":
        fwd = (dispatches["prefill_batch"] + dispatches["decode"]
               + dispatches["decode_iterations"]
               + dispatches.get("verify_batch", 0))
        want = {"ragged": layers * fwd,
                "prefill": layers * dispatches["prefill"]}
    elif impl == "composed":
        want = {"ragged": 0,
                "prefill": layers * (dispatches["prefill"]
                                     + dispatches["prefill_lanes"]),
                "decode": layers * (dispatches["decode"]
                                    + dispatches["decode_iterations"])}
    else:
        want = {"ragged": 0, "prefill": 0, "decode": 0}
    got = {k: launches[k] for k in want}
    print(f"{what}: launches {got}, {layers} x forwards {want}", flush=True)
    if got != want:
        fail(f"{what}: kernel launches {got} are not {layers} a forward "
             f"{want}")


def check_pool(what: str, runner, smi: str) -> None:
    """The graphs' shared pool and the program variants' static buffers,
    both allocated after the KV sizing, against the room that sizing
    keeps back for them (ModelRunner._graph_pool_reserve): fatal above
    it."""
    pool, static = runner.graph_pool_bytes(), runner.static_input_bytes()
    check_pool_bytes(what, pool, static, runner._graph_pool_reserve(), smi)


def check_pool_bytes(what: str, pool: int, static: int, reserve: int,
                     smi: str) -> None:
    print(f"{what}: graph pool {pool / 2**20:.1f} MiB + static inputs "
          f"{static / 2**20:.1f} MiB against the KV sizing's pool reserve "
          f"{reserve / 2**20:.1f} MiB on {smi}", flush=True)
    if pool + static > reserve:
        fail(f"{what}: the graphs' pool and static inputs "
             f"({(pool + static) / 2**20:.1f} MiB) exceed the pool "
             f"reserve ({reserve / 2**20:.1f} MiB)")


def check_logged_pool(what: str, line: str, smi: str) -> None:
    """check_pool_bytes on a CLI engine's "serving precompile" log
    line."""
    m = re.search(r"graph pool ([0-9.]+) MiB, static inputs ([0-9.]+) "
                  r"MiB, pool reserve ([0-9.]+) MiB", line)
    if m is None:
        fail(f"{what}: no pool bytes in the precompile log line: {line}")
    pool, static, reserve = (int(float(x) * 2**20) for x in m.groups())
    check_pool_bytes(what, pool, static, reserve, smi)


def wait_healthy(what: str, proc, port: int, log_path: Path,
                 t0: float) -> float:
    """Seconds from t0 until the server answers /health with 200."""
    while True:
        if proc.poll() is not None:
            fail(f"{what}: server exited with {proc.returncode}:\n"
                 f"{log_tail(log_path)}")
        if time.perf_counter() - t0 > 600:
            fail(f"{what}: server not healthy after 600 s:\n"
                 f"{log_tail(log_path)}")
        try:
            st, body = http(port, "/health", timeout=5)
            if st == 200 and json.loads(body)["status"] == "healthy":
                return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.5)


def serve_phase(torch, smi: str) -> tuple[dict, dict]:
    port = free_port()
    log_path = REPO / "build" / "chip_smoke_serve.log"
    t0 = time.perf_counter()
    proc = start_server(port, log_path, extra=("--precompile-serving",))
    try:
        boot = wait_healthy("serve", proc, port, log_path, t0)
        # the warm-up runs before the server listens: its log line is
        # there by the time /health answers
        warm = [ln for ln in log_path.read_text(errors="replace")
                .splitlines() if "serving precompile:" in ln]
        if not warm:
            fail(f"serve: healthy without the precompile log line:\n"
                 f"{log_tail(log_path)}")
        print(f"serve: healthy {boot:.1f}s after start, after "
              f"{warm[0].split('INFO ', 1)[-1]}", flush=True)
        check_logged_pool("serve", warm[0], smi)
        card = json.loads(http(port, "/v1/models")[1])["data"][0]
        assert card["id"] == "llama-3.2-3b" and card["max_model_len"], card
        assert "kv_role" not in card or card["kv_role"] is None, card

        sent = [0]

        def completion(prompt, n, **extra):
            sent[0] += 1
            st, body = http(port, "/v1/completions", {
                "prompt": prompt, "max_tokens": n, "temperature": 0,
                "ignore_eos": True, **extra})
            r = json.loads(body)
            u = r["usage"]
            ok = (st == 200 and r["choices"][0]["finish_reason"] == "length"
                  and u["completion_tokens"] == n
                  and u["prompt_tokens"] == len(prompt.encode()) + 1
                  and u["total_tokens"] == u["prompt_tokens"] + n)
            if not ok:
                fail(f"serve: bad completion response {body[:400]}")
            return r

        # the main path: launch counts from 0 just before it
        st, body = http(port, "/debug/kernel_launches", method="DELETE")
        zeroed = json.loads(body)
        if st != 200 or any(zeroed["launches"].values()):
            fail(f"serve: launch counts not reset: {body}")

        t1 = time.perf_counter()
        completion("The quick brown fox jumps over the lazy dog.", 32)
        print(f"serve: greedy completion (32 tokens) in "
              f"{time.perf_counter() - t1:.2f}s", flush=True)

        sent[0] += 2  # the streamed completion and the chat request
        st, body = http(port, "/v1/completions", {
            "prompt": "Stream me some tokens", "max_tokens": 16,
            "temperature": 0.8, "top_p": 0.9, "ignore_eos": True,
            "stream": True, "stream_options": {"include_usage": True}})
        events = [ln[6:] for ln in body.splitlines()
                  if ln.startswith("data: ")]
        if st != 200 or events[-1] != "[DONE]":
            fail(f"serve: bad stream {body[:400]}")
        chunks = [json.loads(e) for e in events[:-1]]
        reasons = [c["choices"][0]["finish_reason"] for c in chunks
                   if c["choices"]]
        if reasons[-1] != "length" or chunks[-1]["usage"][
                "completion_tokens"] != 16:
            fail(f"serve: stream ended wrong {chunks[-2:]}")

        st, body = http(port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Say hi."}],
            "max_tokens": 8, "temperature": 0, "ignore_eos": True})
        r = json.loads(body)
        if (st != 200 or r["choices"][0]["message"]["role"] != "assistant"
                or r["usage"]["completion_tokens"] != 8):
            fail(f"serve: bad chat response {body[:400]}")

        # 4 concurrent multi-chunk prompts: their chunks pack into
        # prefill_batch forwards, or into mixed rounds beside the lanes
        # already decoding (ragged kernel on prefill segments either way)
        before = json.loads(http(port, "/debug/kernel_launches")[1])
        prompts = [(f"request {i}: " + "lorem ipsum dolor sit amet " * 45)
                   for i in range(4)]
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            list(ex.map(lambda p: completion(p, 24), prompts))
        report = json.loads(http(port, "/debug/kernel_launches")[1])
        packed = {k: report["dispatches"][k] - before["dispatches"][k]
                  for k in ("prefill_batch", "ragged")}
        print(f"serve: 4 concurrent completions in "
              f"{time.perf_counter() - t1:.2f}s, packed prefill and mixed "
              f"forwards {packed}; since the reset: dispatches "
              f"{report['dispatches']}, launches {report['launches']}",
              flush=True)
        if sum(packed.values()) < 1:
            fail("serve: no packed prefill or mixed forward ran")

        # a ~1500-token prompt (three 512-token chunks) arrives while four
        # greedy requests decode: its chunks ride unified ragged rounds
        gen0 = metric(port, "vllm:generation_tokens_total")
        rounds0 = metric(port, "tpu:ragged_rounds_total")
        t1 = time.perf_counter()
        with ThreadPoolExecutor(5) as ex:
            lanes = [ex.submit(completion, f"decoding lane {i}: " + "ab " * 9,
                               64) for i in range(4)]
            while metric(port, "vllm:generation_tokens_total") < gen0 + 4:
                if any(f.done() for f in lanes):
                    fail("serve: a decoding lane finished before the long "
                         "prompt was sent")
                time.sleep(0.01)
            long_req = ex.submit(completion, "long " + "x y z " * (
                (LONG_PROMPT_TOKENS - 6) // 6), 8)
            for f in lanes + [long_req]:
                f.result()
        rounds = metric(port, "tpu:ragged_rounds_total") - rounds0
        print(f"serve: a {LONG_PROMPT_TOKENS}-token prompt beside 4 decoding "
              f"lanes in "
              f"{time.perf_counter() - t1:.2f}s, {rounds:.0f} mixed rounds "
              "(tpu:ragged_rounds)", flush=True)
        if not rounds > 0:
            fail("serve: no mixed (ragged) round ran")
        metrics = http(port, "/metrics")[1]
        for gauge in ("vllm:num_requests_running",
                      "vllm:num_requests_waiting",
                      "vllm:gpu_cache_usage_perc", "tpu:ragged_rounds_total",
                      "tpu:decode_k_count"):
            if gauge not in metrics:
                fail(f"serve: /metrics lacks {gauge}")
        # one multi-chunk prompt sent twice: the second finds its blocks
        # in the prefix cache; then the router's families are read back
        repeat = "repeat " + "the same words again " * 40
        for _ in range(2):
            completion(repeat, 8)
        samples, types = parse_metrics(http(port, "/metrics")[1])
        for fam, kind in ROUTER_FAMILIES.items():
            if types.get(fam) != kind:
                fail(f"serve: /metrics has {fam} as {types.get(fam)}, not "
                     f"{kind}")

        def one(name):
            return samples[name][0][1]

        finished = sum(v for _, v in samples["vllm:request_success_total"])
        delay_n = one("tpu:scheduling_delay_seconds_count")
        rate = one("vllm:gpu_prefix_cache_hit_rate")
        print(f"serve: router families: prefix-cache hit rate {rate:.4f} "
              f"({one('vllm:gpu_prefix_cache_hits_total'):.0f} / "
              f"{one('vllm:gpu_prefix_cache_queries_total'):.0f} tokens), "
              f"scheduling delay count {delay_n:.0f} sum "
              f"{one('tpu:scheduling_delay_seconds_sum'):.4f} s over "
              f"{finished:.0f} finished requests ({sent[0]} sent); staged "
              f"prefill hits {one('tpu:prefill_staged_hits_total'):.0f}, "
              f"misses {one('tpu:prefill_staged_misses_total'):.0f}, "
              f"chained chunks "
              f"{one('tpu:prefill_chained_chunks_total'):.0f}", flush=True)
        if not rate > 0:
            fail("serve: prefix-cache hit rate 0 after a repeated prompt")
        if not delay_n == finished == sent[0]:
            fail(f"serve: scheduling delay count {delay_n}, finished "
                 f"{finished}, sent {sent[0]} differ")
        report = json.loads(http(port, "/debug/kernel_launches")[1])
        print(f"serve: since the reset: dispatches {report['dispatches']}, "
              f"launches {report['launches']}", flush=True)
        check_launches("serve", report["launches"], report["dispatches"])
        compiles = {tuple(sorted(lab.items())): v for lab, v in
                    samples.get("tpu:compile_events_total", [])}
        print(f"serve: tpu:compile_events_total {compiles}", flush=True)
        if not compiles:
            fail("serve: /metrics lacks tpu:compile_events_total")
        api_launches = api_requests(torch, port, smi)
    finally:
        stop_server(proc)
    print(f"serve: server exited with {proc.returncode}; log tail:\n"
          f"{log_tail(log_path, 8)}", flush=True)
    return report["launches"], api_launches


# -- API phase: the OpenAI request surface ---------------------------------------
GUIDED_SCHEMA = {
    "type": "object",
    "properties": {"age": {"type": "integer"},
                   "mood": {"enum": ["happy", "sad"]}},
    "required": ["age", "mood"],
}
GUIDED_CHOICES = ["alpha", "beta", "betamax"]
# the four constraints of the API phase: request field -> value
GUIDED = {
    "guided_json": GUIDED_SCHEMA,
    "guided_regex": r"(yes|no), [0-9]{2}",
    "guided_choice": GUIDED_CHOICES,
    "guided_regex ab": r"[ab]{8}",
}
WEATHER_TOOL = {
    "type": "function",
    "function": {
        "name": "get_weather", "description": "Get current weather",
        "parameters": {"type": "object",
                       "properties": {"city": {"type": "string"}},
                       "required": ["city"]}}}
# random weights never write a tool call: a guided_regex forces one
TOOL_CALL_RE = (r'<tool_call>\{"name": "get_weather", "arguments": '
                r'\{"city": "(Oslo|Paris)"\}\}</tool_call>')
PLP_PROMPT_TOKENS = 1500  # three 512-token chunks


def guided_field(name: str) -> dict:
    return {name.split()[0]: GUIDED[name]}


def guided_valid(name: str, text: str) -> bool:
    """`text` satisfies constraint GUIDED[name] in full."""
    import re

    if name == "guided_json":
        try:
            v = json.loads(text)
        except json.JSONDecodeError:
            return False
        return (isinstance(v, dict) and isinstance(v.get("age"), int)
                and v.get("mood") in ("happy", "sad"))
    if name == "guided_choice":
        return text in GUIDED_CHOICES
    return re.fullmatch(GUIDED[name], text) is not None


def api_requests(torch, port: int, smi: str) -> dict:
    """The serve phase's CLI server (default config) answers the request
    surface: the four guided constraints and response_format, prompt
    logprobs of a 1500-token prompt held to a one-shot forward's
    log-softmax on the card, n = 3, a batched prompt of 4, a chat with
    tools and a named tool_choice, /tokenize, /detokenize, /version,
    /sleep and /wake_up around a request in flight, /debug/requests.
    Launch counts zeroed just before, read just after; returns them."""
    t_phase = time.perf_counter()
    st, body = http(port, "/debug/kernel_launches", method="DELETE")
    if st != 200 or any(json.loads(body)["launches"].values()):
        fail(f"API phase: launch counts not reset: {body}")

    def post(path, req):
        st, body = http(port, path, req)
        if st != 200:
            fail(f"API phase: {path} answered {st}: {body[:400]}")
        return json.loads(body)

    for name in GUIDED:
        t0 = time.perf_counter()
        r = post("/v1/completions", {"prompt": "Answer: ", "max_tokens": 256,
                                     "temperature": 0,
                                     **guided_field(name)})
        text = r["choices"][0]["text"]
        print(f"API phase: {name} {GUIDED[name]!r} -> {text!r} "
              f"({r['usage']['completion_tokens']} tokens, "
              f"{time.perf_counter() - t0:.2f}s)", flush=True)
        if not guided_valid(name, text):
            fail(f"API phase: {name} answer {text!r} breaks its constraint")
    r = post("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Describe a person."}],
        "max_tokens": 256, "temperature": 0,
        "response_format": {"type": "json_schema", "json_schema": {
            "name": "person", "schema": GUIDED_SCHEMA}}})
    text = r["choices"][0]["message"]["content"]
    print(f"API phase: response_format json_schema -> {text!r}", flush=True)
    if not guided_valid("guided_json", text):
        fail(f"API phase: response_format answer {text!r} breaks its schema")

    r = post("/v1/completions", {"prompt": "Three of a kind:", "n": 3,
                                 "max_tokens": 12, "temperature": 0,
                                 "ignore_eos": True})
    texts = [c["text"] for c in r["choices"]]
    if ([c["index"] for c in r["choices"]] != [0, 1, 2]
            or len(set(texts)) != 1
            or r["usage"]["completion_tokens"] != 36):
        fail(f"API phase: n=3 greedy choices differ or miscount: {r}")
    batch = [f"batched prompt {i}: " + "la " * (3 + 5 * i) for i in range(4)]
    r = post("/v1/completions", {"prompt": batch, "max_tokens": 10,
                                 "temperature": 0, "ignore_eos": True})
    if ([c["index"] for c in r["choices"]] != [0, 1, 2, 3]
            or r["usage"]["completion_tokens"] != 40
            or r["usage"]["prompt_tokens"] != sum(
                len(p.encode()) + 1 for p in batch)):
        fail(f"API phase: bad batched-prompt response {r}")
    print("API phase: n=3 (equal greedy choices) and a batched prompt of 4 "
          "served", flush=True)

    r = post("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Weather in Oslo?"}],
        "tools": [WEATHER_TOOL], "max_tokens": 96, "temperature": 0,
        "tool_choice": {"type": "function",
                        "function": {"name": "get_weather"}},
        "guided_regex": TOOL_CALL_RE})
    choice = r["choices"][0]
    calls = choice["message"].get("tool_calls") or []
    if not (choice["finish_reason"] == "tool_calls" and len(calls) == 1
            and calls[0]["type"] == "function"
            and calls[0]["id"].startswith("call_")
            and calls[0]["function"]["name"] == "get_weather"
            and json.loads(calls[0]["function"]["arguments"])["city"]
            in ("Oslo", "Paris")
            and choice["message"]["content"] is None):
        fail(f"API phase: the tool call is not in the OpenAI shape: {r}")
    print(f"API phase: chat with a named tool_choice -> tool_calls "
          f"{calls[0]['function']}", flush=True)

    text = "Tokenize me, please."
    toks = post("/tokenize", {"prompt": text})
    back = post("/detokenize", {"tokens": toks["tokens"]})["prompt"]
    version = json.loads(http(port, "/version")[1])
    if back != text or toks["count"] != len(toks["tokens"]) or not version.get(
            "version"):
        fail(f"API phase: tokenize round trip {toks} -> {back!r}, "
             f"version {version}")

    # /sleep lands while a request decodes: no token is generated until
    # /wake_up, then the request finishes
    with ThreadPoolExecutor(1) as ex:
        gen0 = metric(port, "vllm:generation_tokens_total")
        fut = ex.submit(post, "/v1/completions", {
            "prompt": "sleep through this", "max_tokens": 160,
            "temperature": 0, "ignore_eos": True})
        while metric(port, "vllm:generation_tokens_total") < gen0 + 2:
            time.sleep(0.005)
        post("/sleep", {})
        if not json.loads(http(port, "/is_sleeping")[1])["is_sleeping"]:
            fail("API phase: /is_sleeping is false after /sleep")
        time.sleep(0.2)  # a step under way ends
        asleep = metric(port, "vllm:generation_tokens_total")
        time.sleep(0.5)
        still = metric(port, "vllm:generation_tokens_total")
        post("/wake_up", {})
        r = fut.result()
    if still != asleep or r["usage"]["completion_tokens"] != 160:
        fail(f"API phase: tokens moved while asleep ({asleep} -> {still}) "
             f"or the request did not finish: {r['usage']}")
    print(f"API phase: /tokenize round trip, /version {version}; a request "
          f"in flight made no token in 0.5 s asleep and finished after "
          f"/wake_up", flush=True)

    ids = [(7 * j + 3) % 250 + 1 for j in range(PLP_PROMPT_TOKENS)]
    t0 = time.perf_counter()
    r = post("/v1/completions", {"prompt": ids, "max_tokens": 1,
                                 "temperature": 0, "prompt_logprobs": 5})
    plp = r["choices"][0]["prompt_logprobs"]
    print(f"API phase: prompt_logprobs 5 of a {PLP_PROMPT_TOKENS}-token "
          f"prompt in {time.perf_counter() - t0:.2f}s", flush=True)
    prompt_logprob_check(torch, ids, plp)

    embedding_requests(torch, port, smi)

    tls = json.loads(http(port, "/debug/requests?limit=256")[1])
    done = [t for t in tls["requests"] if t["finished"]]
    kinds = [[e["name"] for e in t["events"]] for t in done]
    if not (tls["enabled"] and len(done) >= 12 and all(
            k[0] == "enqueue" and k[-1] == "finish" for k in kinds)):
        fail(f"API phase: /debug/requests {len(done)} finished timelines, "
             f"first {kinds[:2]}")
    print(f"API phase: /debug/requests lists {len(done)} finished "
          f"timelines, each enqueue ... finish; the last: {kinds[-1]}",
          flush=True)
    report = json.loads(http(port, "/debug/kernel_launches")[1])
    check_launches("API phase", report["launches"], report["dispatches"])
    print(f"API phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return report["launches"]


def prompt_logprob_check(torch, ids: list[int], plp: list) -> None:
    """The served prompt logprobs (three chunks) against the log-softmax
    of a one-shot forward of the whole prompt on the card (the prefill
    kernel, the server's seeded weights): each chosen and top-5 logprob
    within LOGIT_REL_TOL of the forward's max|logit|."""
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.ops import paged_attention as pa

    cfg = get_model_config("llama-3.2-3b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
    with torch.inference_mode():
        # the prefill kernel takes whole 8-row tiles: pad rows after the
        # prompt (causal, so they change no real row)
        pad = -len(ids) % pa.PREFILL_TQ
        logits = all_row_logits(torch, pa, cfg, params,
                                ids + [0] * pad)[:len(ids)]
        top = float(logits.abs().max())
        lp = torch.log_softmax(logits, dim=-1)
        del logits
        if len(plp) != len(ids) or plp[0] is not None:
            fail(f"API phase: {len(plp)} prompt logprob entries for "
                 f"{len(ids)} prompt tokens")
        rows = torch.arange(len(ids) - 1, device="cuda")
        want = lp[rows, torch.tensor(ids[1:], device="cuda")]
        got = torch.tensor([e["logprob"] for e in plp[1:]], device="cuda")
        top_ids = torch.tensor([[t["token_id"] for t in e["top_logprobs"]]
                                for e in plp[1:]], device="cuda")
        top_got = torch.tensor([[t["logprob"] for t in e["top_logprobs"]]
                                for e in plp[1:]], device="cuda")
        d_chosen = float((got - want).abs().max())
        d_top = float((top_got - lp[rows[:, None], top_ids]).abs().max())
        d_max = float((top_got[:, 0] - lp[rows].max(dim=-1).values)
                      .abs().max())
    del params, lp
    release(torch)
    rel = max(d_chosen, d_top, d_max) / top
    print(f"API phase: prompt logprobs vs a one-shot forward's "
          f"log-softmax: max|d| chosen {d_chosen:.3e}, top-5 {d_top:.3e}, "
          f"top-1 vs the row max {d_max:.3e}; / max|logit| {top:.3f} = "
          f"{rel:.3e} (tol {LOGIT_REL_TOL})", flush=True)
    if not rel <= LOGIT_REL_TOL:
        fail(f"API phase: prompt logprobs off by {rel:.3e} of max|logit|")
    if [e["token_id"] for e in plp[1:]] != ids[1:]:
        fail("API phase: prompt logprob entries name other tokens")


# /v1/embeddings: one pooled vector a text; the last text runs in three
# 512-token chunks over the embedding's own scratch cache
EMBED_LONG_TOKENS = 1500
# served embedding vs a mean-pooled one-shot forward of the same ids on
# the prefill kernel (the server's seeded weights): both pool bf16
# forwards that sum attention in different orders, so they agree to a
# cosine of 1 - O(1e-4); 0.999 is the bound
EMBED_MIN_COSINE = 0.999
# rerank / score against the cosines of the /v1/embeddings vectors: the
# server's float32 dot products against float64 ones of the same vectors
SCORE_TOL = 1e-5


def embedding_requests(torch, port: int, smi: str) -> None:
    """/v1/embeddings on three texts (the last EMBED_LONG_TOKENS tokens,
    three chunks), twice: each vector unit-norm, both calls equal, each
    within EMBED_MIN_COSINE of a mean-pooled one-shot forward of its ids
    on the card; /v1/rerank and /v1/score hold their order and values to
    the cosines of those vectors."""
    import numpy as np

    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.ops import paged_attention as pa

    def post(path, req):
        st, body = http(port, path, req)
        if st != 200:
            fail(f"embeddings: {path} answered {st}: {body[:400]}")
        return json.loads(body)

    texts = ["The cat sat on the mat.",
             "A kitten is resting on a rug in the sun.",
             "long " + "q r s t " * ((EMBED_LONG_TOKENS - 7) // 8)]
    texts[2] += "x" * (EMBED_LONG_TOKENS - 1 - len(texts[2].encode()))
    ids = [post("/tokenize", {"prompt": t})["tokens"] for t in texts]
    if len(ids[2]) != EMBED_LONG_TOKENS:
        fail(f"embeddings: the long text has {len(ids[2])} tokens")
    t0 = time.perf_counter()
    r1 = post("/v1/embeddings", {"input": texts})
    all_s = time.perf_counter() - t0
    r2 = post("/v1/embeddings", {"input": texts, "model": "llama-3.2-3b"})
    t0 = time.perf_counter()
    post("/v1/embeddings", {"input": texts[2]})
    long_s = time.perf_counter() - t0
    vecs = [np.asarray(d["embedding"], np.float64) for d in r1["data"]]
    again = [np.asarray(d["embedding"], np.float64) for d in r2["data"]]
    if ([d["index"] for d in r1["data"]] != [0, 1, 2]
            or r1["usage"]["prompt_tokens"] != sum(map(len, ids))
            or r1["object"] != "list"):
        fail(f"embeddings: bad response shape {str(r1)[:300]}")
    drift = max(float(np.abs(a - b).max()) for a, b in zip(vecs, again))
    norms = [float(np.linalg.norm(v)) for v in vecs]
    if drift != 0.0 or not all(abs(n - 1.0) < 1e-4 for n in norms):
        fail(f"embeddings: two calls differ by {drift} or norms {norms}")

    cfg = get_model_config("llama-3.2-3b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
    cos = []
    with torch.inference_mode():
        for v, tid in zip(vecs, ids):
            pad = -len(tid) % pa.PREFILL_TQ
            h = all_row_logits(torch, pa, cfg, params, tid + [0] * pad,
                               return_hidden=True)[:len(tid)]
            ref = h.double().mean(0).cpu().numpy()
            cos.append(float(ref @ v / np.linalg.norm(ref)))
    del params
    release(torch)
    print(f"embeddings: 3 texts of {[len(t) for t in ids]} tokens in "
          f"{all_s:.3f}s (the server's first embeddings), then the "
          f"{EMBED_LONG_TOKENS}-token text alone in {long_s:.3f}s (3 "
          f"chunks; host clock) on {smi}; unit norms {norms}, "
          f"two calls equal; cosine to a one-shot forward's mean-pooled "
          f"hidden state {cos} (bound {EMBED_MIN_COSINE})", flush=True)
    if not min(cos) >= EMBED_MIN_COSINE:
        fail(f"embeddings: cosine {min(cos)} to the one-shot forward")

    want = [float(vecs[0] @ v) for v in vecs[1:]]
    rr = post("/v1/rerank", {"query": texts[0], "documents": texts[1:]})
    order = sorted(range(2), key=lambda i: -want[i])
    got = [(r["index"], r["relevance_score"]) for r in rr["results"]]
    if ([i for i, _ in got] != order or max(
            abs(s - want[i]) for i, s in got) > SCORE_TOL):
        fail(f"embeddings: rerank {got} against cosines {want}")
    sc = post("/v1/score", {"text_1": texts[0], "text_2": texts[1:]})
    scores = [d["score"] for d in sc["data"]]
    if max(abs(a - b) for a, b in zip(scores, want)) > SCORE_TOL:
        fail(f"embeddings: score {scores} against cosines {want}")
    print(f"embeddings: /v1/rerank order {order} and /v1/score {scores} "
          f"equal the embeddings' cosines {want} (tol {SCORE_TOL})",
          flush=True)


def guided_step_us(torch, token_class, class_mask, class_trans,
                   b: int = 8) -> tuple[float, float]:
    """One iteration's DFA work in the fused loop (the runner's post():
    the lanes' allowed classes spread to the vocab, the mask, the sampled
    token's class, the state step) at b lanes, in µs: (eager, between
    CUDA events over 200 iterations, host enqueue included; device, 20
    iterations captured in one CUDA graph replayed 10 times, so no host
    gap sits between the kernels)."""
    dev = "cuda"
    tc = torch.from_numpy(token_class).to(dev)
    mask = torch.from_numpy(class_mask).to(dev)
    trans = torch.from_numpy(class_trans.astype("int64")).to(dev)
    lane_tc = tc[torch.zeros(b, dtype=torch.long, device=dev)].long()
    g = torch.zeros(b, dtype=torch.long, device=dev)
    logits = torch.randn((b, tc.shape[1]), device=dev)
    nxt = torch.zeros(b, dtype=torch.int32, device=dev)

    def one():
        allowed = torch.gather(mask[g], 1, lane_tc)
        masked = torch.where(allowed, logits,
                             torch.full_like(logits, float("-inf")))
        cls = torch.gather(lane_tc, 1, nxt.long()[:, None])[:, 0]
        return masked, trans[g, cls]

    def span_us(fn, reps: int, per: int) -> float:
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e3 / (reps * per)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for _ in range(10):
            one()
    torch.cuda.current_stream().wait_stream(side)
    eager = span_us(one, 200, 1)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            one()
    graph.replay()
    return eager, span_us(graph.replay, 10, 20)


def guided_phase(torch, pa, gap_tol: float, smi: str) -> dict:
    """In process, 28 layers, bf16: a K=8 engine on the default config
    runs the four guided constraints beside four free lanes. Fails unless
    the DFA tables were built and the fused rounds ran the guided lanes
    on them (runner.guided_rounds), every guided answer satisfies its
    constraint, and the greedy streams equal a K=1 host-masked engine's
    under the near-tie rule. Prints the table builds' ms, the DFA step's
    device µs an iteration at b = 8, and the wall ms a generated token of
    the K=8 round with 8 guided lanes beside the same round without
    constraints, in turns; returns the K=8 engine's launches."""
    from production_stack_tpu_torch.engine import structured
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    t_phase = time.perf_counter()
    engines = {k: LLMEngine(EngineConfig(
        model="llama-3.2-3b", tokenizer="byte", device="cuda",
        block_size=32, num_kv_blocks=256, max_num_seqs=8, seed=SEED,
        num_scheduler_steps=k)) for k in (8, 1)}
    eng = engines[8]
    mc, vocab = eng._mask_cache(), eng.runner.model_config.vocab_size
    eos = eng.tokenizer.eos_token_id
    builds = {}
    structured._TOKEN_DFA_CACHE.clear()
    for name in GUIDED:
        t0 = time.perf_counter()
        if name == "guided_choice":
            spec = [tuple(eng.tokenizer.encode(c, add_bos=False))
                    for c in GUIDED_CHOICES]
        else:
            kind = "json" if name == "guided_json" else "regex"
            spec = structured.get_machine(kind, GUIDED[name])
        dfa = structured.get_token_dfa(spec, mc, vocab, eos)
        if dfa is None:
            fail(f"guided phase: no TokenDFA for {name} at V={vocab}")
        builds[name] = (round((time.perf_counter() - t0) * 1e3, 3),
                        dfa.num_states, dfa.num_classes)
    print(f"guided phase: TokenDFA builds (ms, states, classes) at "
          f"V={vocab}, byte tokenizer: {builds} (host clock)", flush=True)
    eager_us, device_us = guided_step_us(
        torch, dfa.token_class[None], dfa.class_mask, dfa.class_trans)
    print(f"guided phase: the DFA step (mask + class step) at b=8, "
          f"V={vocab}: {eager_us:.2f} µs an iteration eager (CUDA events "
          f"over 200, host enqueue included), {device_us:.2f} µs of device "
          f"time (a CUDA graph of 20 iterations, replayed 10 times) on "
          f"{smi}", flush=True)

    prompts = [[(11 * i + 5 * j) % 250 + 1 for j in range(12 + 9 * i)]
               for i in range(8)]
    sps = [SamplingParams(max_tokens=128, temperature=0, logprobs=2,
                          **guided_field(name)) for name in GUIDED]
    sps += [SamplingParams(max_tokens=40, temperature=0, ignore_eos=True,
                           logprobs=2)] * 4
    outs = {}
    for k, e in engines.items():
        pa.reset_launch_counts()
        runs0 = dict(e.runner.dispatch_counts)
        t0 = time.perf_counter()
        outs[k] = e.generate(prompts, sps)
        torch.cuda.synchronize()
        runs = {key: v - runs0[key]
                for key, v in e.runner.dispatch_counts.items()}
        print(f"guided phase: K={k} engine, 4 guided + 4 free lanes in "
              f"{time.perf_counter() - t0:.3f}s (host clock): fused rounds "
              f"on the device tables {e.runner.guided_rounds}, rounds with "
              f"guided lanes on the host mask {e._guided_host_rounds_total}, "
              f"table uploads {e.runner.guided_table_uploads}; dispatches "
              f"{runs}", flush=True)
        check_launches(f"guided phase K={k}", pa.launch_counts(), runs)
        if k == 8:
            launches = pa.launch_counts()
            if not e.runner.guided_rounds > 0:
                fail("guided phase: no fused round ran guided lanes on the "
                     "device tables")
        for name, o in zip(GUIDED, outs[k]):
            if not guided_valid(name, o.text):
                fail(f"guided phase K={k}: {name} answer {o.text!r} breaks "
                     "its constraint")
    n_same = near_tie_check("guided phase (K=8 vs K=1)", outs[1], outs[8],
                            gap_tol)
    print(f"guided phase: {n_same}/8 greedy streams of the K=8 engine equal "
          f"to the K=1 host-masked engine's; answers "
          f"{[o.text for o in outs[8][:4]]}", flush=True)

    # wall ms a token, 8 guided lanes against 8 free ones, in turns
    guided_sp = SamplingParams(max_tokens=128, temperature=0,
                               guided_regex=r"[a-z]{96}")
    free_sp = SamplingParams(max_tokens=97, temperature=0, ignore_eos=True)
    walls: dict = {"guided": [], "free": []}
    for turn, kind in enumerate(("guided", "free", "free", "guided")):
        for i in range(8):
            eng.add_request(f"w{turn}-{i}", prompt_token_ids=[
                (13 * i + 7 * j + 29 * turn) % 250 + 1 for j in range(24)],
                sampling_params=guided_sp if kind == "guided" else free_sp)
        eng.step()  # the packed prefill: one token each
        torch.cuda.synchronize()
        gen0, t0 = eng.stats().generation_tokens_total, time.perf_counter()
        while eng.has_unfinished():
            eng.step()
        torch.cuda.synchronize()
        n_tok = eng.stats().generation_tokens_total - gen0
        walls[kind].append(round((time.perf_counter() - t0) * 1e3 / n_tok,
                                 4))
    print(f"guided phase: K=8 at batch 8, wall ms a generated token "
          f"(host clock, turns guided, free, free, guided): {walls}; "
          f"guided rounds on the device {eng.runner.guided_rounds}, on the "
          f"host mask {eng._guided_host_rounds_total} on {smi}", flush=True)
    del engines, eng
    release(torch)
    print(f"guided phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return launches


# -- decode-kernel phase -------------------------------------------------------
def decode_step_check(torch, pa, runner, prompts) -> float:
    """One ModelRunner.decode step of the 28-layer model over the same
    cache state on the ragged kernel, on paged_decode_attention, and on
    paged_decode_attention with a planted fault: a lane longer than one
    split walks its keys only up to the start of its last split, so the
    merge misses that split. Fails unless the sound step is within
    DECODE_LOGIT_REL_TOL of the ragged one (max|dlogit| / max|logit|)
    and the faulty step is not; returns the sound step's max|dlogit|."""
    bs = runner.block_size
    tables, nxt = [], 1
    for p in prompts:
        n = -(-(len(p) + 1) // bs)
        tables.append(list(range(nxt, nxt + n)))
        nxt += n
    for p, tb in zip(prompts, tables):
        runner.prefill(p, 0, tb, len(p))
    args = ([11 * (i + 1) for i in range(len(prompts))],
            [len(p) for p in prompts], tables,
            [len(p) + 1 for p in prompts])
    keys = pa.DECODE_SPLIT_KEYS
    assert runner.ragged_kernel and max(args[3]) > keys
    attn = runner._attn

    def skip_last_split(kind, q, layer, kc, vc, tables, ctx):
        ctx = torch.where(ctx > keys, (ctx - 1) // keys * keys, ctx)
        return attn(kind, q, layer, kc, vc, tables, ctx)

    # eager steps: a captured decode graph would replay the first kernel
    # whatever the runner's attention is switched to
    runner.eager = True
    ragged = runner.decode(*args)[:len(prompts)].float()
    runner.ragged_kernel = False
    try:
        dec = runner.decode(*args)[:len(prompts)].float()
        runner._attn = skip_last_split
        bad = runner.decode(*args)[:len(prompts)].float()
    finally:
        runner.ragged_kernel = True
        runner.eager = False
        del runner._attn
    torch.cuda.synchronize()
    if not (torch.isfinite(ragged).all() and torch.isfinite(dec).all()):
        fail("decode phase: non-finite logits")
    top = float(ragged.abs().max())
    dmax = float((dec - ragged).abs().max())
    rel, bad_rel = dmax / top, float((bad - ragged).abs().max()) / top
    print(f"decode phase: one {runner.model_config.num_layers}-layer decode "
          f"step, {len(prompts)} lanes, ragged vs decode kernel: "
          f"max|dlogit|={dmax:.4f}, /max|logit|={rel:.3e} (max|logit| "
          f"{top:.3f}, tol {DECODE_LOGIT_REL_TOL}); with the last split "
          f"of the longest lane skipped: {bad_rel:.3e}", flush=True)
    if not rel <= DECODE_LOGIT_REL_TOL:
        fail(f"decode phase: logits differ by {rel:.3e} of max|logit|")
    if not bad_rel > DECODE_LOGIT_REL_TOL:
        fail(f"decode phase: a skipped split moves the logits by only "
             f"{bad_rel:.3e} of max|logit|: the tolerance cannot see it")
    return dmax


def near_tie_check(what: str, ref, other, gap_tol: float) -> int:
    """Greedy streams of two engines (outputs with top-2 logprobs) that
    sum in different orders may part only where `ref`'s top-2 logprob gap
    at the first differing step is below gap_tol; returns how many are
    equal."""
    n_same = 0
    for i, (r, d) in enumerate(zip(ref, other)):
        if r.token_ids == d.token_ids:
            n_same += 1
            continue
        k = next(k for k, (a, b) in enumerate(zip(r.token_ids, d.token_ids))
                 if a != b)
        top2 = r.logprobs[k]["top_logprobs"]
        gap = top2[0]["logprob"] - top2[1]["logprob"]
        print(f"{what}: request {i} diverges at step {k}: "
              f"{r.token_ids[k]} vs {d.token_ids[k]}, top-2 logprob gap "
              f"{gap:.4f} (passes below {gap_tol:.4f})", flush=True)
        if not gap < gap_tol:
            fail(f"{what}: request {i} diverges at step {k} with a top-2 "
                 f"gap of {gap:.4f} >= {gap_tol:.4f}")
    return n_same


def decode_phase(torch, pa) -> tuple[dict, float]:
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    prompts = [[(7 * i + 3 * j) % 256 + 1 for j in range(n)]
               for i, n in enumerate((5, 33, 97, 300))]
    sp = SamplingParams(max_tokens=12, temperature=0, ignore_eos=True,
                        logprobs=2)
    outs, counts, gap_tol = {}, {}, None
    for ragged in (True, False):
        eng = LLMEngine(EngineConfig(
            model="llama-3.2-3b", tokenizer="byte", device="cuda",
            block_size=32, num_kv_blocks=256, max_num_seqs=4, seed=SEED,
            ragged_kernel=ragged, ragged_dispatch=ragged,
        ))
        pa.reset_launch_counts()
        t0 = time.perf_counter()
        outs[ragged] = eng.generate(prompts, sp)
        torch.cuda.synchronize()
        print(f"decode phase: {'ragged' if ragged else 'decode'}-kernel "
              f"engine generated {len(prompts)} x {sp.max_tokens} tokens in "
              f"{time.perf_counter() - t0:.3f}s (host clock, prefill "
              "included)", flush=True)
        if not ragged:
            counts = pa.launch_counts()
        else:
            # the direct check, on this engine's weights after its run: a
            # greedy parting passes only below its largest logit change
            gap_tol = decode_step_check(torch, pa, eng.runner, prompts)
        del eng
        release(torch)
    n_same = near_tie_check("decode phase", outs[True], outs[False],
                            gap_tol)
    print(f"decode phase: --no-ragged-kernel engine launches {counts}; "
          f"{n_same}/{len(prompts)} greedy token sequences equal to the "
          "ragged-kernel engine's", flush=True)
    return counts, gap_tol


# -- pipeline phase ------------------------------------------------------------
def stage_readback_check(torch, runner) -> None:
    """Each stage_* buffer, read back once its copy event has fired,
    equals byte for byte what the unstaged dispatch builds from the same
    arguments; and a packed prefill dispatch consuming a staged buffer
    gives the unstaged dispatch's tokens and logits."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    bs = runner.block_size
    blocks = iter(range(400, 1 << 20))

    def table(n_tok):
        return [next(blocks) for _ in range(-(-n_tok // bs))]

    b = runner.config.max_num_seqs
    temps = np.zeros(b, np.float32)
    top_ps, top_ks = np.ones(b, np.float32), np.full(b, -1, np.int32)
    keys = np.stack([np.arange(b), np.full(b, 7)], 1).astype(np.uint32)
    # the prefill tables first: the packed prefill below writes through
    # them, so they stay inside the cache; the decode lanes' are only
    # read back
    chunks = [rng.integers(1, 250, size=n).tolist() for n in (512, 300, 77)]
    starts = [0, 64, 0]
    pf_tabs = [table(s + len(c)) for s, c in zip(starts, chunks)]
    assert max(max(t) for t in pf_tabs) < runner.num_blocks
    totals = [s + len(c) for s, c in zip(starts, chunks)]
    ctx = [int(c) for c in rng.integers(20, 900, size=b)]
    dec_tabs = [table(c + 16) for c in ctx]
    pos = [c - 1 for c in ctx]
    stop = (np.full(b, 2, np.int32), np.zeros(b, np.int32),
            np.full(b, 20, np.int32), None)
    # (temps, top_ps, top_ks, min_ps, keys)
    sampling = (np.zeros(3, np.float32), np.ones(3, np.float32),
                np.full(3, -1, np.int32), np.zeros(3, np.float32),
                np.zeros((3, 2), np.uint32))
    c_pad = runner._ctx_bucket(max(ctx) + 7)
    cases = {
        "stage_prefill": (
            runner.stage_prefill(chunks[0], 0, pf_tabs[0], totals[0]),
            runner._fill_prefill_pack(chunks[0], 0, pf_tabs[0],
                                      totals[0])[-1]),
        "stage_prefill_batch": (
            runner.stage_prefill_batch(chunks, starts, pf_tabs, totals,
                                       sampling=sampling),
            runner._fill_rows_prefill_pack(chunks, starts, pf_tabs, totals,
                                           sampling=sampling)[-1]),
        "stage_decode_multi": (
            runner.stage_decode_multi(pos, dec_tabs, ctx, 8, temps, top_ps,
                                      top_ks, keys, stop=stop),
            runner._fill_decode_pack(c_pad, 8, None, pos, dec_tabs, ctx,
                                     temps, top_ps, top_ks, keys, stop=stop,
                                     chained=True)),
        "stage_ragged": (
            runner.stage_ragged(chunks[1:], starts[1:], pf_tabs[1:],
                                totals[1:], None, pos, dec_tabs, ctx, 8,
                                temps, top_ps, top_ks, keys, stop=stop),
            runner._fill_ragged_rows_pack(
                chunks[1:], starts[1:], pf_tabs[1:], totals[1:], None,
                c_pad, None, pos, dec_tabs, ctx, 8, temps, top_ps, top_ks,
                keys, stop=stop, chained=True)[-1]),
    }
    for name, (h, want) in cases.items():
        h.event.synchronize()
        got = h.dev.cpu().numpy()
        same = got.dtype == want.dtype and got.shape == want.shape and (
            got.tobytes() == want.tobytes())
        print(f"pipeline phase: {name}: {got.size * 4} bytes read back after "
              f"the copy event, {'equal' if same else 'DIFFERENT'} to the "
              f"unstaged build", flush=True)
        if not same:
            fail(f"pipeline phase: the {name} buffer differs from the "
                 "unstaged dispatch's")
    h = runner.stage_prefill_batch(chunks, starts, pf_tabs, totals,
                                   sampling=sampling)
    tok_s, lg_s = runner.prefill_batch(chunks, starts, pf_tabs, totals,
                                       sampling=sampling, staged=h)
    tok_u, lg_u = runner.prefill_batch(chunks, starts, pf_tabs, totals,
                                       sampling=sampling)
    torch.cuda.synchronize()
    if not (torch.equal(tok_s[:3], tok_u[:3])
            and torch.equal(lg_s[:3], lg_u[:3])):
        fail("pipeline phase: a staged packed prefill differs from the "
             "unstaged one")
    print("pipeline phase: packed prefill on a staged buffer: tokens and "
          "logits equal to the unstaged dispatch's", flush=True)


def pipeline_phase(torch, pa, smi: str) -> None:
    """In process, 28 layers, bf16: a cold ~1500-token prompt alone chains
    its three 512-token chunks in one engine step with one fetch; the
    staged buffers read back equal the unstaged builds; and the prefill
    phase seconds of the same work on the default (staged) engine and on
    one with --no-prefill-pipeline --no-prefetch-decode."""
    from production_stack_tpu_torch.engine import llm_engine
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    cold = [(5 * j) % 250 + 1 for j in range(LONG_PROMPT_TOKENS)]
    group = [[(13 * i + 3 * j) % 250 + 1 for j in range(700)]
             for i in range(4)]
    sp = SamplingParams(max_tokens=4, temperature=0, ignore_eos=True)
    for staged in (True, False):
        name = "staged" if staged else "unstaged"
        eng = llm_engine.LLMEngine(EngineConfig(
            model="llama-3.2-3b", tokenizer="byte", device="cuda",
            block_size=32, num_kv_blocks=512, max_num_seqs=8, seed=SEED,
            prefill_pipeline=staged, prefetch_decode=staged,
        ))
        phase0 = dict(eng.runner.prefill_phase_s)
        pa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.add_request("cold", prompt_token_ids=cold, sampling_params=sp)
        fetches = []
        to_numpy = llm_engine._to_numpy
        llm_engine._to_numpy = lambda t: (fetches.append(1), to_numpy(t))[1]
        try:
            eng.step()
        finally:
            llm_engine._to_numpy = to_numpy
        d = eng.runner.dispatch_counts
        print(f"pipeline phase: {name} engine, first step on the cold "
              f"{LONG_PROMPT_TOKENS}-token prompt: {eng.last_step_kind}, "
              f"{d['prefill']} prefill forwards, chained chunks "
              f"{eng._pf_chained_chunks_total}, {len(fetches)} fetch(es)",
              flush=True)
        if staged and not (eng.last_step_kind == "prefill"
                           and d["prefill"] == 3
                           and eng._pf_chained_chunks_total == 2
                           and len(fetches) == 1):
            fail("pipeline phase: the cold prompt's three chunks did not "
                 "chain in one step with one fetch")
        while eng.has_unfinished():
            eng.step()
        for i, p in enumerate(group):
            eng.add_request(f"g{i}", prompt_token_ids=p, sampling_params=sp)
        while eng.has_unfinished():
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        phases = {k: round(v - phase0[k], 4)
                  for k, v in eng.runner.prefill_phase_s.items()}
        print(f"pipeline phase: {name} engine, the cold prompt then 4 "
              f"x 700-token prompts: {wall:.3f} s wall, prefill phase "
              f"seconds {phases}, staged prefill hits "
              f"{eng._pf_staged_hits_total} misses "
              f"{eng._pf_staged_misses_total}, chained chunks "
              f"{eng._pf_chained_chunks_total} (host clock) on {smi}",
              flush=True)
        check_launches(f"pipeline phase, {name} engine", pa.launch_counts(),
                       eng.runner.dispatch_counts)
        if staged:
            stage_readback_check(torch, eng.runner)
        del eng
        release(torch)


# -- mixed-round phase ---------------------------------------------------------
def profile_step(torch, step) -> str:
    """One engine step under torch.profiler: its wall time, the device
    time of the CUDA kernels it ran (busy share of the wall) and the
    kernels taking most of it ("not measured" without device events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us:
            kern.append((us / 1e3, ev.count, ev.key))
    if not kern:
        return f"wall {wall_ms:.2f} ms, device time not measured"
    kern.sort(reverse=True)
    dev_ms = sum(k[0] for k in kern)
    top = "; ".join(f"{name[:60]} x{n} {ms:.3f} ms ({ms / dev_ms:.1%})"
                    for ms, n, name in kern[:8])
    return (f"wall {wall_ms:.2f} ms, device {dev_ms:.3f} ms in "
            f"{sum(k[1] for k in kern)} kernels (busy {dev_ms / wall_ms:.1%} "
            f"of the wall); top: {top}")


# this phase's reads before the prefill pipeline and the decode prefetch
# existed, printed beside this run's: wall ms per generated token at
# batch 8 by K, and a mixed round's wall ms at K=8 (NVIDIA H100 80GB
# HBM3, 700 W; another machine, so they set a scale, not a baseline)
UNSTAGED_MS_PER_TOKEN = {1: 6.501, 8: 5.478}
UNSTAGED_MIXED_ROUND_MS = 414.83


def mixed_phase(torch, pa, gap_tol: float, smi: str) -> dict:
    """In-process 28-layer engines serve the same staggered mix (four
    greedy requests, then a ~1500-token prompt while they decode): K=8
    with unified ragged rounds on the default config (prefill pipeline
    and decode prefetch on), the same without them, and a split K=1
    engine; then decode at batch 8. The two K=8 engines take their turns
    twice, in the order default, unstaged, unstaged, default, each turn
    on prompts of its own (the prefix cache would serve a repeat).
    Returns the default K=8 engine's launch counts over its turns."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    # 32 tokens: at K=8 the decode lanes take 1 + 8 (step 1) and then
    # ride all three of the long prompt's chunks (steps 2-4, the last
    # round exiting after 7 iterations)
    sp = SamplingParams(max_tokens=32, temperature=0, ignore_eos=True,
                        logprobs=2)
    default, unstaged, split = ("K=8 ragged default", "K=8 ragged unstaged",
                                "K=1 split")
    specs = {default: (8, True), unstaged: (8, False), split: (1, True)}
    engines = {
        name: LLMEngine(EngineConfig(
            model="llama-3.2-3b", tokenizer="byte", device="cuda",
            block_size=32, num_kv_blocks=512, max_num_seqs=8, seed=SEED,
            num_scheduler_steps=k, ragged_dispatch=k > 1,
            prefill_pipeline=staged, prefetch_decode=staged,
        )) for name, (k, staged) in specs.items()
    }
    launches = {name: dict.fromkeys(("decode", "prefill", "ragged"), 0)
                for name in specs}
    outs: dict = {}

    def mix(name: str, turn: int, profile: bool) -> None:
        """The staggered mix on prompts of this turn; its streams, the
        wall of each mixed round, launches held to 28 a forward."""
        eng = engines[name]
        k = specs[name][0]
        prompts = [[(11 * i + 5 * j + 17 * turn) % 250 + 1 for j in range(n)]
                   for i, n in enumerate((17, 40, 64, 90))]
        long_prompt = [(3 * j + 7 * turn) % 250 + 1
                       for j in range(LONG_PROMPT_TOKENS)]
        pa.reset_launch_counts()
        runs0 = dict(eng.runner.dispatch_counts)
        st0 = eng.stats()
        for i, p in enumerate(prompts):
            eng.add_request(f"t{turn}d{i}", prompt_token_ids=p,
                            sampling_params=sp)
        finals, mixed_ms, step, prof = {}, [], 0, None
        t0 = time.perf_counter()
        while eng.has_unfinished():
            if step == 2:
                eng.add_request(f"t{turn}long", prompt_token_ids=long_prompt,
                                sampling_params=sp)
            before = eng.stats().ragged_rounds_total
            ts = time.perf_counter()
            if profile and step == 4:
                # the third mixed round, under the profiler (the first
                # two are timed without it)
                prof = profile_step(torch, lambda: finals.update(
                    {o.request_id: o for o in eng.step() if o.finished}))
            else:
                finals.update({o.request_id: o for o in eng.step()
                               if o.finished})
                torch.cuda.synchronize()
                if eng.stats().ragged_rounds_total > before:
                    mixed_ms.append((time.perf_counter() - ts) * 1e3)
            step += 1
        st = eng.stats()
        runs = {key: v - runs0[key]
                for key, v in eng.runner.dispatch_counts.items()}
        got = pa.launch_counts()
        for key in launches[name]:
            launches[name][key] += got[key]
        hist = {kk: n - st0.decode_k_hist.get(kk, 0)
                for kk, n in sorted(st.decode_k_hist.items())}
        n_mixed = st.ragged_rounds_total - st0.ragged_rounds_total
        what = f"mixed phase {name}, turn {turn}"
        print(f"{what}: {step} steps in {time.perf_counter() - t0:.3f}s "
              f"(host clock), {n_mixed} mixed rounds, decode K histogram "
              f"{hist}; dispatches {runs}", flush=True)
        check_launches(what, got, runs)
        if k > 1:
            if not (n_mixed > 0 and hist.get(8)):
                fail(f"{what}: no mixed round or no K=8 round ran")
            print(f"{what}: mixed-round wall ms "
                  f"{[round(x, 2) for x in mixed_ms]} (host clock, step() "
                  f"to synchronize; before staging: "
                  f"{UNSTAGED_MIXED_ROUND_MS} ms) on {smi}",
                  flush=True)
            if profile:
                print(f"{what}: one mixed round under torch.profiler: "
                      f"{prof or 'step 4 did not run'}", flush=True)
        outs[name, turn] = [finals[f"t{turn}{r}"]
                            for r in ("d0", "d1", "d2", "d3", "long")]

    def decode8(name: str, turn: int) -> None:
        """Decode at batch 8: wall ms per generated token."""
        k = specs[name][0]
        ms = decode_batch8(torch, engines[name], "t", turn)
        print(f"mixed phase {name}, turn {turn}: decode at batch 8: "
              f"{ms:.3f} wall ms per generated token (host clock; before "
              f"staging at K={k}: {UNSTAGED_MS_PER_TOKEN[k]}) on {smi}",
              flush=True)

    turns = [(default, 0), (unstaged, 0), (unstaged, 1), (default, 1)]
    for name, turn in turns:
        mix(name, turn, profile=(name, turn) == (default, 0))
    mix(split, 0, profile=False)
    for name, turn in turns + [(split, 0)]:
        decode8(name, turn)
    for name, eng in engines.items():
        hits = {"decode": (eng._staged_hits_total, eng._staged_misses_total),
                "ragged": (eng._ragged_staged_hits_total,
                           eng._ragged_staged_misses_total),
                "prefill": (eng._pf_staged_hits_total,
                            eng._pf_staged_misses_total)}
        print(f"mixed phase {name}: staged (hits, misses) {hits}",
              flush=True)
        if name == default and not (hits["decode"][0] > 0
                                    and hits["ragged"][0] > 0):
            fail(f"mixed phase {name}: no staged decode or ragged round "
                 "was consumed")
    for other, turn in ((unstaged, 0), (unstaged, 1), (split, 0)):
        ref = outs[default, turn]
        n_same = near_tie_check(f"mixed phase (vs {other}, turn {turn})",
                                ref, outs[other, turn], gap_tol)
        print(f"mixed phase: {n_same}/{len(ref)} greedy token sequences of "
              f"the default K=8 engine equal to the {other} engine's "
              f"(turn {turn})", flush=True)
    del engines
    release(torch)
    return launches[default]


# -- composed and gather phases --------------------------------------------------
def staggered_mix(torch, pa, eng, tag: str, turn: int, sp,
                  profile: list | None = None,
                  n_long: int | None = None) -> tuple:
    """The mixed phase's scenario on one engine: four greedy requests,
    then a LONG_PROMPT_TOKENS (or `n_long`) prompt at step 2 while they
    decode, on prompts of this turn. Returns (outputs d0..d3, long; launch counts;
    dispatch counts; lane-typed rounds; wall seconds), launches and
    dispatches counted from 0 just before it. With `profile`, step 4 (a
    mixed round) runs under torch.profiler and its summary is appended
    there (that step's wall is inside the returned seconds)."""
    prompts = [[(11 * i + 5 * j + 17 * turn) % 250 + 1 for j in range(n)]
               for i, n in enumerate((17, 40, 64, 90))]
    long_prompt = [(3 * j + 7 * turn) % 250 + 1
                   for j in range(n_long or LONG_PROMPT_TOKENS)]
    pa.reset_launch_counts()
    runs0 = dict(eng.runner.dispatch_counts)
    rounds0 = eng.stats().ragged_rounds_total
    for i, p in enumerate(prompts):
        eng.add_request(f"{tag}{turn}d{i}", prompt_token_ids=p,
                        sampling_params=sp)
    finals, step = {}, 0
    t0 = time.perf_counter()
    while eng.has_unfinished():
        if step == 2:
            eng.add_request(f"{tag}{turn}long", prompt_token_ids=long_prompt,
                            sampling_params=sp)
        if profile is not None and step == 4:
            profile.append(profile_step(torch, lambda: finals.update(
                {o.request_id: o for o in eng.step() if o.finished})))
        else:
            finals.update({o.request_id: o for o in eng.step()
                           if o.finished})
        step += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs = {k: v - runs0[k] for k, v in eng.runner.dispatch_counts.items()}
    return ([finals[f"{tag}{turn}{r}"] for r in ("d0", "d1", "d2", "d3",
                                                  "long")],
            pa.launch_counts(), runs,
            eng.stats().ragged_rounds_total - rounds0, wall)


def decode_batch8(torch, eng, tag: str, turn: int) -> float:
    """Eight 32-token prompts packed into one prefill, then decoded to
    33 tokens each: wall ms per generated token of the decode (host
    clock, synchronized)."""
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    bsp = SamplingParams(max_tokens=33, temperature=0, ignore_eos=True)
    for i in range(8):
        eng.add_request(f"{tag}{turn}b{i}", prompt_token_ids=[
            (7 * i + j + 13 * turn) % 250 + 1 for j in range(32)],
            sampling_params=bsp)
    eng.step()  # the packed prefill: one token each
    torch.cuda.synchronize()
    gen0, t0 = eng.stats().generation_tokens_total, time.perf_counter()
    while eng.has_unfinished():
        eng.step()
    torch.cuda.synchronize()
    n_tok = eng.stats().generation_tokens_total - gen0
    return (time.perf_counter() - t0) * 1e3 / n_tok


def impl_phase(torch, pa, gap_tol: float, smi: str) -> dict:
    """The composed ragged round and the gather path at Llama-3.2-3B
    (28 layers, bf16), K=8 on the default ragged dispatch, beside the
    ragged-kernel engine on the same seeded weights: --no-ragged-kernel
    (attention_impl pallas: the prefill kernel a padded prefill lane a
    layer, the decode kernel a layer an iteration, no ragged launch) and
    --attention-impl xla (no kernel launch). Each serves the mixed
    phase's scenario and decodes at batch 8, in turns ragged, composed,
    gather, gather, composed, ragged; their greedy streams are held to
    the ragged-kernel engine's of the same turn under the near-tie rule.
    Returns the composed engine's launches."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config

    t_phase = time.perf_counter()
    sp = SamplingParams(max_tokens=32, temperature=0, ignore_eos=True,
                        logprobs=2)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(get_model_config("llama-3.2-3b"), gen,
                               torch.bfloat16, "cuda")
    specs = {"ragged": {}, "composed": {"ragged_kernel": False,
                                        "attention_impl": "pallas"},
             "gather": {"attention_impl": "xla"}}
    engines = {
        name: LLMEngine(EngineConfig(
            model="llama-3.2-3b", tokenizer="byte", device="cuda",
            block_size=32, num_kv_blocks=512, max_num_seqs=8, seed=SEED,
            num_scheduler_steps=8, **over), params=params)
        for name, over in specs.items()}
    impls = {name: eng.runner.attention_impl
             for name, eng in engines.items()}
    if impls != {"ragged": "pallas", "composed": "pallas", "gather": "xla"}:
        fail(f"impl phase: runners resolved {impls}")
    outs, walls, launches = {}, {}, dict.fromkeys(("decode", "prefill",
                                                   "ragged"), 0)
    turns = [("ragged", 0), ("composed", 0), ("gather", 0), ("gather", 1),
             ("composed", 1), ("ragged", 1)]
    for name, turn in turns:
        eng = engines[name]
        outs[name, turn], got, runs, n_mixed, wall = staggered_mix(
            torch, pa, eng, name, turn, sp)
        what = f"impl phase {name}, turn {turn}"
        print(f"{what}: mixed scenario in {wall:.3f}s (host clock), "
              f"{n_mixed} lane-typed rounds; dispatches {runs}", flush=True)
        if n_mixed < 1:
            fail(f"{what}: no lane-typed round ran")
        if name != "ragged":
            impl = "composed" if name == "composed" else "xla"
            check_launches(what, got, runs, impl=impl)
        else:
            check_launches(what, got, runs)
        if name == "composed":
            for k in launches:
                launches[k] += got[k]
        walls[name, turn] = decode_batch8(torch, eng, name, turn)
    for name in ("composed", "gather"):
        for turn in (0, 1):
            n_same = near_tie_check(
                f"impl phase ({name} vs ragged, turn {turn})",
                outs["ragged", turn], outs[name, turn], gap_tol)
            print(f"impl phase: {n_same}/5 greedy token sequences of the "
                  f"{name} engine equal to the ragged-kernel engine's "
                  f"(turn {turn})", flush=True)
    print(f"impl phase: decode at batch 8, K=8, wall ms per generated "
          f"token (host clock, turns {[f'{n}{t}' for n, t in turns]}): "
          + ", ".join(f"{n} {walls[n, t]:.3f}" for n, t in turns)
          + f" on {smi}", flush=True)
    del engines, params
    release(torch)
    print(f"impl phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return launches


# -- compiled programs and async decode ------------------------------------------
# the compiled phase caps the precompile grid: contexts up to 2048 tokens
# (ctx buckets 32..2048) and 512-token prefill chunks (buckets 8..512)
COMPILED_MAX_MODEL_LEN = 2048
COMPILED_MAX_PREFILL_CHUNK = 512


def compiled_engine(torch, params, k: int, eager: bool = False, **over):
    """A 3B engine on `params`, K=k, contexts capped for the grid:
    compiled (program variants, CUDA graphs), or its eager control."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine

    cfg = EngineConfig(
        model="llama-3.2-3b", tokenizer="byte", device="cuda",
        block_size=32, num_kv_blocks=512, max_num_seqs=8, seed=SEED,
        num_scheduler_steps=k, max_model_len=COMPILED_MAX_MODEL_LEN,
        max_prefill_chunk=COMPILED_MAX_PREFILL_CHUNK, **over)
    return LLMEngine(cfg, params=params, eager=eager)


def profiled_decode_round(torch, eng, tag: str) -> str:
    """Eight 32-token prompts prefilled, one decode round under
    torch.profiler (the second after the prefill), the rest run out."""
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    sp = SamplingParams(max_tokens=33, temperature=0, ignore_eos=True)
    for i in range(8):
        eng.add_request(f"{tag}p{i}", prompt_token_ids=[
            (5 * i + 3 * j) % 250 + 1 for j in range(32)], sampling_params=sp)
    for _ in range(2):
        eng.step()
    prof = profile_step(torch, eng.step)
    while eng.has_unfinished():
        eng.step()
    return prof


def graphed_vs_eager(what: str, engs: dict, outs: dict, turn: int, sp,
                     gap_tol: float, torch, pa) -> None:
    """The graphed engine's greedy streams of one turn equal the eager
    engine's, or part only at near ties: the eager engine then runs the
    turn again with top-2 logprobs for the near-tie rule."""
    ref, got = outs["eager", turn], outs["graphed", turn]
    n_same = sum(a.token_ids == b.token_ids for a, b in zip(ref, got))
    if n_same < len(ref):
        from production_stack_tpu_torch.engine.sampling_params import (
            SamplingParams,
        )

        lp = SamplingParams(max_tokens=sp.max_tokens, temperature=0,
                            ignore_eos=True, logprobs=2)
        ref = staggered_mix(torch, pa, engs["eager"], "lp", turn, lp)[0]
        near_tie_check(what, ref, got, gap_tol)
    print(f"{what}: {n_same}/{len(ref)} greedy token sequences of the "
          "graphed engine equal to the eager engine's", flush=True)


# the program kinds precompile_serving must build, by engine: the JAX
# runner's jit caches (_prefill_fns, _prefill_batch_fns on the ragged-rows
# layout, _ragged_fns, _decode_fns, _decode_multi_fns)
COMPILED_KINDS = {8: {"prefill", "prefill_rows", "ragged_rows", "decode",
                      "decode_multi"},
                  1: {"prefill", "prefill_rows", "decode"}}


def compiled_phase(torch, pa, gap_tol: float, smi: str) -> tuple:
    """The compiled programs at Llama-3.2-3B (28 layers, bf16, random
    weights): a K=8 engine on the defaults runs precompile_serving (its
    dispatches, seconds, compile events by kind, the graph pool's bytes,
    the static inputs' bytes and the pool reserve the KV sizing keeps
    printed, with the grid; every kind of COMPILED_KINDS built), then
    serves the mixed phase's scenario (greedy, no logprobs: shapes the
    sweep covered) in turns graphed, eager, eager, graphed against its
    eager control on the same params: no compile event in the graphed
    turns, launches 28 a forward counted on replay and equal to the
    eager engine's, greedy streams equal (or parting at near ties), one
    mixed round of each turn under torch.profiler (its wall and busy
    share printed by engine). Then wall ms a token at batch 8 in turns
    and one pure decode round of each under the profiler; then the same
    on split K=1 engines (--no-ragged-dispatch: the single-step decode
    graphs). Returns the graphed engines' launches, the params and the
    K=8 graphed engine, kept for the sync phase."""
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config

    t_phase = time.perf_counter()
    sp = SamplingParams(max_tokens=32, temperature=0, ignore_eos=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(get_model_config("llama-3.2-3b"), gen,
                               torch.bfloat16, "cuda")
    launches = dict.fromkeys(("decode", "prefill", "ragged"), 0)
    turns = [("graphed", 0), ("eager", 0), ("eager", 1), ("graphed", 1)]
    for k, over in ((8, {}), (1, {"ragged_dispatch": False})):
        engs = {"graphed": compiled_engine(torch, params, k, **over),
                "eager": compiled_engine(torch, params, k, eager=True,
                                         **over)}
        tag = f"compiled phase K={k}" + (" split" if k == 1 else "")
        g = engs["graphed"].runner
        t0 = time.perf_counter()
        n = engs["graphed"].precompile_serving()
        secs = time.perf_counter() - t0
        print(f"{tag}: precompile_serving {n} dispatches in {secs:.2f}s "
              f"(host clock) over the grid {engs['graphed'].precompile_grid}"
              f"; compile events {g.compile_events} "
              f"({g.compile_events_total} variants), graph pool "
              f"{g.graph_pool_bytes()} bytes "
              f"({g.graph_pool_bytes() / 2**20:.1f} MiB), static inputs "
              f"{g.static_input_bytes()} bytes, pool reserve of the KV "
              f"sizing {g._graph_pool_reserve()} bytes on {smi}",
              flush=True)
        missing = COMPILED_KINDS[k] - set(g.compile_events)
        if not n > 0 or missing:
            fail(f"{tag}: the sweep built no {sorted(missing)} variant")
        check_pool(tag, g, smi)
        outs, runs_of, busy = {}, {}, {}
        for name, turn in turns:
            eng = engs[name]
            ev0 = dict(eng.runner.compile_events)
            prof = []
            outs[name, turn], got, runs, n_mixed, wall = staggered_mix(
                torch, pa, eng, f"c{k}", turn, sp, profile=prof)
            new = {kind: v - ev0.get(kind, 0)
                   for kind, v in eng.runner.compile_events.items()
                   if v != ev0.get(kind, 0)}
            what = f"{tag} {name}, turn {turn}"
            print(f"{what}: mixed scenario in {wall:.3f}s (host clock), "
                  f"{n_mixed} lane-typed rounds; dispatches {runs}; new "
                  f"compile events {new}", flush=True)
            check_launches(what, got, runs)
            if name == "graphed" and new:
                fail(f"{what}: compile events {new} inside precompiled "
                     "shapes")
            if k > 1 and n_mixed < 1:
                fail(f"{what}: no lane-typed round ran")
            print(f"{what}: step 4 (a mixed round) under torch.profiler: "
                  f"{prof[0]}", flush=True)
            busy[name, turn] = re.search(r"^wall ([0-9.]+) ms.*?(?:busy "
                                         r"([0-9.]+)%|$)", prof[0]).groups()
            runs_of[name, turn] = (got, runs)
            if name == "graphed":
                for kk in launches:
                    launches[kk] += got[kk]
        print(f"{tag}: a mixed round (step 4) wall ms / device busy % by "
              f"turn: " + ", ".join(f"{n}{t} {busy[n, t][0]} / "
                                    f"{busy[n, t][1] or 'not measured'}"
                                    for n, t in turns) + f" on {smi}",
              flush=True)
        for turn in (0, 1):
            if runs_of["graphed", turn] != runs_of["eager", turn]:
                fail(f"{tag}, turn {turn}: graphed (launches, dispatches) "
                     f"{runs_of['graphed', turn]} differ from the eager "
                     f"engine's {runs_of['eager', turn]}")
            graphed_vs_eager(f"{tag} (graphed vs eager, turn {turn})", engs,
                             outs, turn, sp, gap_tol, torch, pa)
        walls = {(name, turn): decode_batch8(torch, engs[name], f"b{k}",
                                             turn)
                 for name, turn in turns}
        print(f"{tag}: decode at batch 8, wall ms per generated token "
              f"(host clock, turns {[f'{n}{t}' for n, t in turns]}): "
              + ", ".join(f"{n} {walls[n, t]:.3f}" for n, t in turns)
              + f" on {smi}", flush=True)
        for name in ("graphed", "eager"):
            print(f"{tag} {name}: one pure decode round at batch 8 under "
                  f"torch.profiler: "
                  f"{profiled_decode_round(torch, engs[name], f'q{k}')}",
                  flush=True)
        if k == 8:
            kept = engs["graphed"]
        del engs, g
        release(torch)
    print(f"compiled phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return launches, params, kept


def async_phase(torch, pa, smi: str) -> dict:
    """async_decode at Llama-3.2-3B (28 layers, bf16): a K=8 engine with
    --async-decode against the synchronous K=8 engine on the same params
    serves 8 prompts at once, 4 greedy and 4 seeded sampled lanes: the
    streams must be bit-identical and the chain must engage (rounds
    dispatched on the previous round's device tokens > 0); launches 28 a
    forward; wall ms a token at batch 8 in turns async, sync, sync,
    async. Returns the async engine's launches."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(get_model_config("llama-3.2-3b"), gen,
                               torch.bfloat16, "cuda")
    engs = {name: LLMEngine(EngineConfig(
        model="llama-3.2-3b", tokenizer="byte", device="cuda",
        block_size=32, num_kv_blocks=512, max_num_seqs=8, seed=SEED,
        num_scheduler_steps=8, max_model_len=COMPILED_MAX_MODEL_LEN,
        async_decode=name == "async"), params=params)
        for name in ("async", "sync")}
    chained = [0]
    can_chain = engs["async"]._can_chain

    def counting():
        ok = can_chain()
        chained[0] += ok
        return ok

    engs["async"]._can_chain = counting
    prompts = [[(9 * i + 4 * j) % 250 + 1 for j in range(24 + 5 * i)]
               for i in range(8)]
    sps = [SamplingParams(max_tokens=48, ignore_eos=True,
                          **({"temperature": 0} if i < 4 else
                             {"temperature": 0.8, "top_p": 0.95,
                              "seed": 100 + i}))
           for i in range(8)]
    outs, counts = {}, {}
    for name, eng in engs.items():
        pa.reset_launch_counts()
        runs0 = dict(eng.runner.dispatch_counts)
        t0 = time.perf_counter()
        outs[name] = [o.token_ids for o in eng.generate(prompts, sps)]
        torch.cuda.synchronize()
        runs = {k: v - runs0[k] for k, v in eng.runner.dispatch_counts.items()}
        counts[name] = pa.launch_counts()
        print(f"async phase {name}: 8 x 48 tokens in "
              f"{time.perf_counter() - t0:.3f}s (host clock); dispatches "
              f"{runs}; compile events {eng.runner.compile_events}",
              flush=True)
        check_launches(f"async phase {name}", counts[name], runs)
    same = sum(a == b for a, b in zip(outs["async"], outs["sync"]))
    print(f"async phase: {same}/8 streams (4 greedy, 4 sampled) of the "
          f"async engine bit-identical to the sync engine's; "
          f"{chained[0]} rounds chained on device tokens", flush=True)
    if same != 8:
        fail("async phase: async streams differ from the sync engine's")
    if not chained[0] > 0:
        fail("async phase: no round was chained")
    turns = [("async", 0), ("sync", 0), ("sync", 1), ("async", 1)]
    walls = {(n, t): decode_batch8(torch, engs[n], "a", t)
             for n, t in turns}
    print(f"async phase: decode at batch 8, K=8, wall ms per generated "
          f"token (host clock, turns {[f'{n}{t}' for n, t in turns]}): "
          + ", ".join(f"{n} {walls[n, t]:.3f}" for n, t in turns)
          + f" on {smi}", flush=True)
    del engs, params
    release(torch)
    print(f"async phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return counts["async"]


# -- sync phase ------------------------------------------------------------------
SYNC_MSG = "called a synchronizing CUDA operation"
PKG = REPO / "production_stack_tpu_torch"
SYNC_B8_TOKENS = 33


class SyncCensus:
    """The host syncs of the port's code, counted by site: the innermost
    frame inside production_stack_tpu_torch/ of every sync that CUDA's
    sync debug mode ("warn") reports, and of every explicit
    torch.cuda.synchronize / Event.synchronize / Stream.synchronize call
    (wrapped while the census is on, so a sync the debug mode misses is
    counted, and one it sees is counted once). A sync whose stack passes
    through ProgramVariant._warm_and_capture (a graph's warm-up and
    capture) is counted apart; one with no frame in the package (the
    caller's own) is not a site."""

    def __init__(self, torch):
        import threading

        self.torch = torch
        self.sites: dict[str, int] = {}
        self.capture: dict[str, int] = {}
        self.callers: dict[str, dict[str, int]] = {}
        self.how: dict[str, set] = {}
        self.outside = 0
        self.round = 0
        self.local = threading.local()

    @staticmethod
    def _rel(frame) -> str:
        return (f"{Path(frame.f_code.co_filename).relative_to(REPO)}:"
                f"{frame.f_lineno}")

    def record(self, frame, how: str) -> None:
        inner, caller, capture = None, None, False
        f = frame
        while f is not None:
            name = f.f_code.co_filename
            if name.startswith(str(PKG) + os.sep):
                if inner is None:
                    inner = f
                elif caller is None:
                    caller = f
                if f.f_code.co_name == "_warm_and_capture":
                    capture = True
            f = f.f_back
        if inner is None:
            self.outside += 1
            return
        site = self._rel(inner)
        book = self.capture if capture else self.sites
        book[site] = book.get(site, 0) + 1
        self.how.setdefault(site, set()).add(how)
        if not capture:
            self.round += 1
            by = self.callers.setdefault(site, {})
            c = self._rel(caller) if caller is not None else "-"
            by[c] = by.get(c, 0) + 1

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if SYNC_MSG in str(message):
            if not getattr(self.local, "inside", False):
                self.record(sys._getframe(1), "debug mode")
            return
        self._orig_show(message, category, filename, lineno, file, line)

    def _wrap(self, fn, how: str):
        census = self

        def wrapped(*args, **kwargs):
            if getattr(census.local, "inside", False):
                return fn(*args, **kwargs)
            census.record(sys._getframe(1), how)
            census.local.inside = True
            try:
                return fn(*args, **kwargs)
            finally:
                census.local.inside = False

        return wrapped

    def __enter__(self):
        import warnings

        torch = self.torch
        self._saved = (torch.cuda.synchronize, torch.cuda.Event.synchronize,
                       torch.cuda.Stream.synchronize)
        self._warn = warnings.catch_warnings()
        self._warn.__enter__()
        warnings.filterwarnings("always", message=f".*{SYNC_MSG}")
        self._orig_show = warnings.showwarning
        warnings.showwarning = self._show
        torch.cuda.synchronize = self._wrap(self._saved[0],
                                            "torch.cuda.synchronize")
        torch.cuda.Event.synchronize = self._wrap(self._saved[1],
                                                  "Event.synchronize")
        torch.cuda.Stream.synchronize = self._wrap(self._saved[2],
                                                   "Stream.synchronize")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch = self.torch
        torch.cuda.set_sync_debug_mode("default")
        (torch.cuda.synchronize, torch.cuda.Event.synchronize,
         torch.cuda.Stream.synchronize) = self._saved
        self._warn.__exit__(*exc)
        return False


def debug_mode_sees(torch) -> dict:
    """Which explicit syncs CUDA's sync debug mode reports on this
    build: each call made once under "warn", its warnings counted."""
    import warnings

    x = torch.ones(4, device="cuda")
    ev = torch.cuda.Event()
    ev.record()
    calls = {
        "torch.cuda.synchronize": torch.cuda.synchronize,
        "Event.synchronize": ev.synchronize,
        "Stream.synchronize": torch.cuda.current_stream().synchronize,
        ".item()": lambda: x.sum().item(),
    }
    seen = {}
    for name, call in calls.items():
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        seen[name] = sum(SYNC_MSG in str(w.message) for w in got)
    return seen


ANALYZER_CMD = ("-m", "production_stack_tpu_torch.analysis",
                "production_stack_tpu_torch/", "--json")


def analyzer_verdicts(report: dict) -> tuple[dict, dict]:
    """The port's analyzer over its own package: (its device-sync
    findings, suppressed or not, by "file:line" from the CLI's --json
    `report`; not-hot functions by file as (first line, last line,
    name))."""
    from production_stack_tpu_torch.analysis.core import (
        ModuleContext,
        iter_functions,
    )

    by_line = {}
    for f in report["findings"] + report["suppressed"]:
        if f["rule"].startswith("device-sync"):
            by_line.setdefault(f"{f['path']}:{f['line']}", f)
    not_hot: dict[str, list] = {}
    for path in sorted(PKG.rglob("*.py")):
        ctx = ModuleContext(str(path), path.read_text())
        for fn in iter_functions(ctx.tree):
            if ctx.is_not_hot(fn):
                lo = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
                not_hot.setdefault(str(path.relative_to(REPO)), []).append(
                    (lo, fn.end_lineno, fn.name))
    return by_line, not_hot


def verdict(site: str, by_line: dict, not_hot: dict) -> str:
    """The analyzer's word on a sync site: its finding's rule (suppressed
    or not), the not-hot function it lies in, or "unreported"."""
    f = by_line.get(site)
    if f is not None:
        return (f"suppressed {f['rule']}" if f["suppressed"]
                else f"UNSUPPRESSED {f['rule']}")
    path, line = site.rsplit(":", 1)
    for lo, hi, name in not_hot.get(path, ()):
        if lo <= int(line) <= hi:
            return f"not-hot {name}"
    return "unreported"


def fused_loop_lines() -> tuple[str, int, int]:
    """(path, first line, last line) of the fused decode loop, the
    closure `run` of ModelRunner._decode_round_core: where its early
    exit read the `done` flag back once an iteration."""
    import ast

    path = PKG / "engine" / "model_runner.py"
    for fn in ast.walk(ast.parse(path.read_text())):
        if (isinstance(fn, ast.FunctionDef)
                and fn.name == "_decode_round_core"):
            for sub in ast.walk(fn):
                if isinstance(sub, ast.FunctionDef) and sub.name == "run":
                    return (str(path.relative_to(REPO)), sub.lineno,
                            sub.end_lineno)
    fail("sync phase: no fused loop in engine/model_runner.py")


def early_exit_module():
    """scripts/chip_early_exit.py: the fused loop's idle-iteration count
    (its round wrapper and its stop-token scenario)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_early_exit", REPO / "scripts" / "chip_early_exit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def census_scenario(torch, pa, eng, tag: str, census) -> tuple:
    """The mixed scenario (four greedy 32-token requests, a
    LONG_PROMPT_TOKENS prompt at step 2) then eight 32-token prompts
    decoded to SYNC_B8_TOKENS tokens at batch 8. Returns (the outputs'
    token ids, launches, dispatches, {round kind: [syncs a step]}),
    launches and dispatches counted from 0 just before it; a step's kind
    is the engine's last_step_kind, " b8" in the batch-8 part."""
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    sp = SamplingParams(max_tokens=32, temperature=0, ignore_eos=True)
    bsp = SamplingParams(max_tokens=SYNC_B8_TOKENS, temperature=0,
                         ignore_eos=True)
    prompts = [[(11 * i + 5 * j) % 250 + 1 for j in range(n)]
               for i, n in enumerate((17, 40, 64, 90))]
    long_prompt = [(3 * j) % 250 + 1 for j in range(LONG_PROMPT_TOKENS)]
    rounds: dict[str, list[int]] = {}
    finals: dict = {}

    def step(part: str) -> None:
        census.round = 0
        finals.update({o.request_id: o for o in eng.step() if o.finished})
        rounds.setdefault(eng.last_step_kind + part, []).append(
            census.round)

    pa.reset_launch_counts()
    runs0 = dict(eng.runner.dispatch_counts)
    for i, p in enumerate(prompts):
        eng.add_request(f"{tag}d{i}", prompt_token_ids=p, sampling_params=sp)
    n = 0
    while eng.has_unfinished():
        if n == 2:
            eng.add_request(f"{tag}long", prompt_token_ids=long_prompt,
                            sampling_params=sp)
        step("")
        n += 1
    for i in range(8):
        eng.add_request(f"{tag}b{i}", prompt_token_ids=[
            (7 * i + j) % 250 + 1 for j in range(32)], sampling_params=bsp)
    while eng.has_unfinished():
        step(" b8")
    runs = {k: v - runs0[k] for k, v in eng.runner.dispatch_counts.items()}
    ids = [finals[f"{tag}{r}"].token_ids for r in
           ("d0", "d1", "d2", "d3", "long", *(f"b{i}" for i in range(8)))]
    return ids, pa.launch_counts(), runs, rounds


def sync_phase(torch, pa, smi: str, params, graphed) -> dict:
    """The host syncs of the served path at Llama-3.2-3B (28 layers,
    bf16, random weights, byte tokenizer), held to the port's analyzer.
    `graphed` is a K=8 engine on the defaults (ragged kernel, unified
    rounds, graphed decode programs after precompile_serving; contexts
    capped at COMPILED_MAX_MODEL_LEN: the compiled phase's) on `params`;
    a --no-ragged-kernel engine (the prefill and decode kernels) on the
    same params runs its own precompile_serving (the composed sweeps and
    precompile_cover's per-lane keys). Each runs census_scenario twice,
    its prefix cache emptied before each: first plain, then under
    SyncCensus. Fatal: a compile event in either run (after the sweep
    the served scenario builds nothing), a sync site in the package the
    analyzer does not report (no device-sync finding at its line and no
    not-hot function around it), streams under the census that differ
    from the plain run's, and `python -m production_stack_tpu_torch.analysis
    production_stack_tpu_torch/` (run with --json beside the engines)
    exiting non-zero. Prints syncs a step by round kind (mean and max),
    each site's count, how it was seen, its most frequent caller and the
    analyzer's verdict, and the captures' syncs apart. The fused loop's
    `done` site (any sync inside _decode_round_core's run) must read 0.
    Each engine's fused rounds are counted (scripts/chip_early_exit.py):
    the iterations they ran after every lane was done, in the census runs
    (budget stops) and in the stop-token scenario (lanes stopping on the
    data at different iterations; the default engine's then on an eager
    control): its streams must be the same on every engine. Returns the
    engines' launches."""
    t_phase = time.perf_counter()
    ee = early_exit_module()
    from production_stack_tpu_torch.engine.model_runner import ModelRunner
    cmd = [sys.executable, *ANALYZER_CMD]
    analyzer = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    print(f"sync phase: CUDA sync debug mode reports, a call: "
          f"{debug_mode_sees(torch)} (torch {torch.__version__} on {smi})",
          flush=True)
    problems = []
    runs_of = {}
    for impl in ("ragged", "composed"):
        tag = f"sync phase {impl}"
        if impl == "ragged":
            eng, n = graphed, "the compiled phase's"
        else:
            eng = compiled_engine(torch, params, 8, ragged_kernel=False)
            t0 = time.perf_counter()
            n = eng.precompile_serving()
            print(f"{tag}: precompile_serving {n} dispatches in "
                  f"{time.perf_counter() - t0:.2f}s (host clock); compile "
                  f"events {eng.runner.compile_events}, graph pool "
                  f"{eng.runner.graph_pool_bytes() / 2**20:.1f} MiB on "
                  f"{smi}", flush=True)
            check_pool(tag, eng.runner, smi)
        bm = eng.block_manager

        def run(tag_, census):
            for h in list(bm.cached_blocks):
                bm.drop_cached_block(h)
            return census_scenario(torch, pa, eng, tag_, census)

        log, undo = ee.count_rounds(ModelRunner)
        try:
            ev0 = dict(eng.runner.compile_events)
            plain = run("p", SyncCensus(torch))
            census = SyncCensus(torch)
            with census:
                ids, got, runs, rounds = run("s", census)
            torch.cuda.synchronize()
            new = {k: v - ev0.get(k, 0) for k, v in
                   eng.runner.compile_events.items() if v != ev0.get(k, 0)}
            idle = ee.idle_counts(log)
            stops = {"graphed": ee.early_exit_scenario(torch, eng,
                                                       f"x{impl}", log)}
            if impl == "ragged":
                control = compiled_engine(torch, params, 8, eager=True)
                stops["eager"] = ee.early_exit_scenario(torch, control,
                                                        f"y{impl}", log)
                control.shutdown()
                del control
        finally:
            undo()
        print(f"{tag}: fused rounds of the census runs (budget stops): "
              f"{idle}; stop-token scenario (scripts/chip_early_exit.py): "
              f"{stops} on {smi}", flush=True)
        if len({v["digest"] for v in stops.values()} | set(
                [runs_of["ragged"][3]] if impl != "ragged" else [])) != 1:
            problems.append(f"{impl}: the stop-token streams differ "
                            "from the graphed ragged engine's")
        if stops["graphed"]["idle_forwards"]:
            problems.append(f"{impl}: the graphed loop ran "
                            f"{stops['graphed']['idle_forwards']} forwards "
                            "after every lane was done")
        check_launches(tag, got, runs, impl=impl)
        same = sum(a == b for a, b in zip(plain[0], ids))
        print(f"{tag}: {n} warm-up dispatches before; {same}/{len(ids)} "
              f"greedy streams under the census equal to the plain run's; "
              f"compile events during the plain and census runs {new}; "
              f"dispatches {runs} on {smi}", flush=True)
        if new:
            problems.append(f"{impl}: the served scenario built {new} "
                            "after precompile_serving")
        if same != len(ids):
            problems.append(f"{impl}: streams with sync debug mode on "
                            "differ from the plain run's")
        runs_of[impl] = (got, rounds, census, stops["graphed"]["digest"])
        eng.shutdown()
        del eng, bm
        release(torch)
    del params, graphed
    release(torch)
    out, err = analyzer.communicate(timeout=300)
    report = json.loads(out) if analyzer.returncode in (0, 1) else None
    print(f"sync phase: python {' '.join(ANALYZER_CMD)} exits "
          f"{analyzer.returncode}: "
          + (f"{report['files_scanned']} file(s), "
             f"{report['summary']['unsuppressed']} finding(s), "
             f"{report['summary']['suppressed']} suppressed"
             if report else err[-2000:]), flush=True)
    if analyzer.returncode != 0:
        print(out[-6000:] + err[-2000:], flush=True)
        problems.append(f"the port's analyzer exits {analyzer.returncode}")
    by_line, not_hot = analyzer_verdicts(report) if report else ({}, {})
    loop_path, lo, hi = fused_loop_lines()
    launches = dict.fromkeys(("decode", "prefill", "ragged"), 0)
    for impl, (got, rounds, census, _) in runs_of.items():
        tag = f"sync phase {impl}"
        for k in launches:
            launches[k] += got.get(k, 0)
        per_kind = ", ".join(
            f"{kind} {sum(v) / len(v):.2f} / {max(v)} over {len(v)}"
            for kind, v in sorted(rounds.items()))
        print(f"{tag}: syncs a step by round kind (mean / max over steps): "
              f"{per_kind}; {sum(census.sites.values())} syncs at "
              f"{len(census.sites)} sites in the package, "
              f"{census.outside} outside it, on {smi}", flush=True)
        for site, cnt in sorted(census.sites.items(), key=lambda kv: -kv[1]):
            v = verdict(site, by_line, not_hot)
            caller = max(census.callers[site].items(), key=lambda kv: kv[1])
            print(f"  {site} x{cnt} ({', '.join(sorted(census.how[site]))}; "
                  f"caller {caller[0]} x{caller[1]}; {smi}): {v}",
                  flush=True)
            if v == "unreported" or v.startswith("UNSUPPRESSED"):
                problems.append(f"{impl} {site}: {v}")
        for site, cnt in sorted(census.capture.items()):
            print(f"  capture {site} x{cnt} ({smi}): "
                  f"{verdict(site, by_line, not_hot)} (graph warm-up and "
                  "capture, apart)", flush=True)
        done = sum(cnt for site, cnt in census.sites.items()
                   if site.rsplit(":", 1)[0] == loop_path
                   and lo <= int(site.rsplit(":", 1)[1]) <= hi)
        print(f"{tag}: the fused loop's done site ({loop_path}:{lo}-{hi}, "
              f"_decode_round_core's run) reads {done} syncs on {smi}",
              flush=True)
        if done:
            problems.append(f"{impl}: {done} syncs inside the fused loop")
    if problems:
        fail("sync phase: " + "; ".join(problems))
    print(f"sync phase: {time.perf_counter() - t_phase:.1f}s (host clock) "
          f"on {smi}", flush=True)
    return launches


# -- spec phase ------------------------------------------------------------------
SPEC_TOKENS = 64
SPEC_K = 4
SPEC_TEMP = 0.8


def spec_prompt(i: int, n: int = 48) -> list[int]:
    """A repetitive prompt (a period-6 cycle, shifted by i): prompt
    lookup finds its trailing n-gram earlier in the context."""
    return [(5 * i + j % 6) % 250 + 1 for j in range(n)]


def sampled_tie_check(torch, pa, what: str, eng, prompt: list[int], ref,
                      other, seed: int, gap_tol: float) -> bool:
    """The near-tie rule of a sampled lane (temperature SPEC_TEMP) of two
    engines that sum differently. The sampler adds the noise of key
    (seed, step) to the TOP_CAP largest logits by RANK, so a parting at
    step k is explained by logit differences up to gap_tol when each
    engine's token could hold a winning rank: with the logits of a
    one-shot forward of the prompt and the reference's first k tokens
    (the engine's weights; it differs from each engine by up to gap_tol
    too, hence 2 * gap_tol), a rank r can win if its perturbed score
    v_r / T + g_r is within 2 * gap_tol / T of the best (the two leading
    scores' near tie), and a token can hold rank r if its logit is
    within 2 * gap_tol of v_r (ranks swap among near-equal logits).
    Fails unless both engines' tokens at step k can; returns whether the
    streams are equal."""
    from production_stack_tpu_torch.engine.sampler import gumbel_noise

    if ref == other:
        return True
    k = next(k for k, (a, b) in enumerate(zip(ref, other)) if a != b)
    ids = prompt + list(ref[:k])
    pad = -len(ids) % pa.PREFILL_TQ
    cap = eng.runner._top_cap
    with torch.inference_mode():
        row = all_row_logits(torch, pa, eng.runner.model_config,
                             eng.runner.params, ids + [0] * pad)[len(ids) - 1]
        vals = torch.topk(row, cap).values.cpu().numpy()
        picks = row[[ref[k], other[k]]].cpu().numpy()
    scores = vals / SPEC_TEMP + gumbel_noise([(seed & 0xFFFFFFFF, k)],
                                             cap)[0]
    can_win = vals[scores >= scores.max() - 2 * gap_tol / SPEC_TEMP]
    dist = [float(abs(can_win - p).min()) for p in picks]
    print(f"{what}: sampled lane (seed {seed}) diverges at step {k}: "
          f"{ref[k]} vs {other[k]}; {len(can_win)} rank(s) within "
          f"{2 * gap_tol / SPEC_TEMP:.4f} of the best perturbed score, the "
          f"two tokens' logits {dist[0]:.4f} and {dist[1]:.4f} from one of "
          f"them (pass at most {2 * gap_tol:.4f})", flush=True)
    if not max(dist) <= 2 * gap_tol:
        fail(f"{what}: sampled lane diverges at step {k}, a token "
             f"{max(dist):.4f} from every winnable rank's logit")
    return False


def spec_phase(torch, pa, gap_tol: float, smi: str,
               model: str = "llama-3.2-3b", device: str = "cuda") -> dict:
    """Speculative decoding (n-gram drafts, one packed verify forward a
    round) on `model` (main hands it the 3B at full width and CKPT_LAYERS
    layers as a checkpoint): in-process engines on the default
    config with num_speculative_tokens=SPEC_K and without it, in turns:
    a repetitive prompt at batch 1, then batch 8 (4 greedy lanes, 4
    seeded sampled lanes), SPEC_TOKENS tokens each. Greedy streams part
    only under the near-tie rule, sampled ones under sampled_tie_check;
    drafts and verify dispatches > 0, launches one a layer a forward (a verify
    forward is one ragged launch a layer); the acceptance rate and the
    wall ms a token at batch 1 (spec / plain, 4 turns) printed. Then the
    composed verify (--no-ragged-kernel --no-ragged-dispatch, one
    prefill launch a lane a layer) at batch 2, and the CLI with
    --num-speculative-tokens whose /metrics carries both
    vllm:spec_decode_* counters. Returns the spec engine's launches.
    `model` and `device` exist for a dry run of the phase's logic on a
    CPU with a tiny model."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models.config import get_model_config

    layers = get_model_config(model).num_layers

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def engine(spec: int, **over):
        return LLMEngine(EngineConfig(
            model=model, tokenizer="byte", device=device,
            block_size=32, num_kv_blocks=512, max_num_seqs=8, seed=SEED,
            num_speculative_tokens=spec, **over))

    spec_eng, plain_eng = engine(SPEC_K), engine(0)
    greedy = SamplingParams(max_tokens=SPEC_TOKENS, temperature=0,
                            ignore_eos=True)
    greedy_lp = SamplingParams(max_tokens=SPEC_TOKENS, temperature=0,
                               ignore_eos=True, logprobs=2)

    def sampled(i):
        return SamplingParams(max_tokens=SPEC_TOKENS, temperature=SPEC_TEMP,
                              seed=1000 + i, ignore_eos=True)

    launches = dict.fromkeys(("decode", "prefill", "ragged"), 0)
    outs: dict = {}

    def run(name, eng, prompts, sps):
        pa.reset_launch_counts()
        runs0 = dict(eng.runner.dispatch_counts)
        st0 = eng.stats()
        for i, (p, sp) in enumerate(zip(prompts, sps)):
            eng.add_request(f"{name}{i}", prompt_token_ids=p,
                            sampling_params=sp)
        eng.step()  # the prefill: one token each
        sync()
        t0 = time.perf_counter()
        finals = {}
        while eng.has_unfinished():
            finals.update({o.request_id: o for o in eng.step()
                           if o.finished})
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        runs = {k: v - runs0[k] for k, v in eng.runner.dispatch_counts.items()}
        got = pa.launch_counts()
        st = eng.stats()
        drafts = st.spec_draft_tokens_total - st0.spec_draft_tokens_total
        acc = st.spec_accepted_tokens_total - st0.spec_accepted_tokens_total
        what = f"spec phase {name}"
        check_launches(what, got, runs, layers=layers)
        if eng is spec_eng:
            for k in launches:
                launches[k] += got[k]
            if not (drafts > 0 and runs["verify_batch"] > 0):
                fail(f"{what}: {drafts} drafts, {runs['verify_batch']} "
                     "verify dispatches")
        n_tok = len(prompts) * (SPEC_TOKENS - 1)
        print(f"{what}: {n_tok} tokens after the prefill in {ms:.1f} ms = "
              f"{ms / n_tok:.3f} wall ms a generated token (host clock) on "
              f"{smi}; dispatches {runs}; drafts {drafts}, accepted {acc}"
              + (f" (acceptance {acc / drafts:.3f})" if drafts else ""),
              flush=True)
        return [finals[f"{name}{i}"] for i in range(len(prompts))], ms / n_tok

    # batch 1, in turns spec / plain / plain / spec, each on its own prompt
    ms = {"spec": [], "plain": []}
    for turn, name in enumerate(("spec", "plain", "plain", "spec")):
        eng = spec_eng if name == "spec" else plain_eng
        # the plain engine's first turn reads the reference of turn 0
        p = spec_prompt(turn if turn != 1 else 0)
        o, t = run(f"{name}-b1-t{turn}", eng, [p],
                   [greedy if name == "spec" else greedy_lp])
        ms[name].append(round(t, 3))
        outs[name, turn] = o
    same = near_tie_check("spec phase batch 1", outs["plain", 1],
                          outs["spec", 0], gap_tol)
    print(f"spec phase: batch 1 greedy stream equal to plain decode: "
          f"{same == 1}; wall ms a generated token at batch 1, spec "
          f"{ms['spec']} vs plain {ms['plain']} (turns spec, plain, plain, "
          f"spec; host clock) on {smi}", flush=True)

    # batch 8: 4 greedy + 4 seeded sampled lanes
    prompts = [spec_prompt(10 + i, 40 + 8 * i) for i in range(8)]
    sps_spec = [greedy] * 4 + [sampled(i) for i in range(4, 8)]
    sps_plain = [greedy_lp] * 4 + [sampled(i) for i in range(4, 8)]
    o_spec, _ = run("spec-b8", spec_eng, prompts, sps_spec)
    o_plain, _ = run("plain-b8", plain_eng, prompts, sps_plain)
    same = near_tie_check("spec phase batch 8", o_plain[:4], o_spec[:4],
                          gap_tol)
    same_s = sum(sampled_tie_check(
        torch, pa, "spec phase batch 8", spec_eng, prompts[i],
        o_plain[i].token_ids, o_spec[i].token_ids, 1000 + i, gap_tol)
        for i in range(4, 8))
    print(f"spec phase: batch 8: {same}/4 greedy and {same_s}/4 sampled "
          "streams equal to plain decode", flush=True)
    st = spec_eng.stats()
    print(f"spec phase: spec engine drafts {st.spec_draft_tokens_total}, "
          f"accepted {st.spec_accepted_tokens_total}, acceptance rate "
          f"{st.spec_accepted_tokens_total / st.spec_draft_tokens_total:.3f}"
          f"; staged decode (hits, misses) ({spec_eng._staged_hits_total}, "
          f"{spec_eng._staged_misses_total})", flush=True)
    del spec_eng, plain_eng
    if device == "cuda":
        release(torch)

    # the composed verify: one prefill launch a padded lane a layer (the
    # runner counts the lanes of its packed forwards as it dispatches
    # them, replayed or not: prefill_lanes)
    eng = engine(SPEC_K, ragged_kernel=False, ragged_dispatch=False)
    prompts = [spec_prompt(20), spec_prompt(21, 56)]
    pa.reset_launch_counts()
    runs0 = dict(eng.runner.dispatch_counts)
    t0 = time.perf_counter()
    o_comp = eng.generate(prompts, SamplingParams(
        max_tokens=24, temperature=0, ignore_eos=True))
    sync()
    runs = {k: v - runs0[k] for k, v in eng.runner.dispatch_counts.items()}
    got = pa.launch_counts()
    want = {"ragged": 0, "decode": layers * runs["decode"],
            "prefill": layers * (runs["prefill"]
                                 + runs["prefill_lanes"])}
    print(f"spec phase composed: 2 x 24 tokens in "
          f"{time.perf_counter() - t0:.2f}s (host clock) on {smi}; "
          f"dispatches {runs}; launches {got}, want {want}",
          flush=True)
    if not (runs["verify_batch"] > 0
            and {k: got[k] for k in want} == want):
        fail(f"spec phase composed: no verify forward or launches not "
             f"{layers} a lane a forward")
    del eng
    ref_eng = engine(0)
    o_ref = ref_eng.generate(prompts, SamplingParams(
        max_tokens=24, temperature=0, ignore_eos=True, logprobs=2))
    del ref_eng
    if device == "cuda":
        release(torch)
    same = near_tie_check("spec phase composed", o_ref, o_comp, gap_tol)
    print(f"spec phase composed: {same}/2 greedy streams equal to plain "
          "decode on the ragged kernel", flush=True)

    # the CLI with --num-speculative-tokens: both counters on /metrics
    port = free_port()
    log_path = REPO / "build" / "chip_smoke_spec_serve.log"
    t0 = time.perf_counter()
    proc = start_server(port, log_path, model=model, extra=(
        "--num-speculative-tokens", str(SPEC_K)) + (
        () if device == "cuda" else ("--device", device)))
    try:
        boot = wait_healthy("spec serve", proc, port, log_path, t0)
        http(port, "/debug/kernel_launches", method="DELETE")
        text = "".join(chr(97 + j % 6) for j in range(60))
        with ThreadPoolExecutor(4) as ex:
            res = list(ex.map(lambda i: http(port, "/v1/completions", {
                "prompt": f"{i} {text}", "max_tokens": 32, "temperature": 0,
                "ignore_eos": True}), range(4)))
        if any(st != 200 or json.loads(b)["usage"]["completion_tokens"] != 32
               for st, b in res):
            fail(f"spec serve: bad completion {res[0][1][:300]}")
        samples, types = parse_metrics(http(port, "/metrics")[1])
        fams = ("vllm:spec_decode_num_draft_tokens_total",
                "vllm:spec_decode_num_accepted_tokens_total")
        vals = [samples.get(f, [(None, -1)])[0][1] for f in fams]
        report = json.loads(http(port, "/debug/kernel_launches")[1])
        print(f"spec serve: healthy {boot:.1f}s after start on {smi}; 4 "
              f"completions; /metrics {dict(zip(fams, vals))}; dispatches "
              f"{report['dispatches']}", flush=True)
        if not (all(types.get(f) == "counter" for f in fams)
                and vals[0] > 0 and 0 <= vals[1] <= vals[0]
                and report["dispatches"]["verify_batch"] > 0):
            fail("spec serve: the vllm:spec_decode_* counters or the verify "
                 "dispatches did not move")
        check_launches("spec serve", report["launches"],
                       report["dispatches"], layers=layers)
    finally:
        stop_server(proc)
    return launches


# -- families phase ------------------------------------------------------------
# published config.json of each model (Hugging Face Hub, the model's main
# revision; fields the loader does not read left out), cut to 2 layers
FAMILY_CONFIGS = {
    # Qwen/Qwen2-7B: 28 query heads over 4 kv heads (g = 7), qkv bias;
    # its sliding_window is off (use_sliding_window false)
    "Qwen2-7B": {
        "architectures": ["Qwen2ForCausalLM"], "hidden_act": "silu",
        "hidden_size": 3584, "intermediate_size": 18944,
        "max_position_embeddings": 131072, "max_window_layers": 28,
        "num_attention_heads": 28, "num_hidden_layers": 28,
        "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
        "rope_theta": 1000000.0, "sliding_window": 131072,
        "tie_word_embeddings": False, "use_sliding_window": False,
        "vocab_size": 152064},
    # mistralai/Mistral-7B-v0.1: a 4096-token sliding window
    "Mistral-7B-v0.1": {
        "architectures": ["MistralForCausalLM"], "hidden_act": "silu",
        "hidden_size": 4096, "intermediate_size": 14336,
        "max_position_embeddings": 32768, "num_attention_heads": 32,
        "num_hidden_layers": 32, "num_key_value_heads": 8,
        "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
        "sliding_window": 4096, "tie_word_embeddings": False,
        "vocab_size": 32000},
    # meta-llama/Llama-3.2-1B: head_dim 64, tied embeddings
    "Llama-3.2-1B": {
        "architectures": ["LlamaForCausalLM"], "head_dim": 64,
        "hidden_act": "silu", "hidden_size": 2048,
        "intermediate_size": 8192, "max_position_embeddings": 131072,
        "num_attention_heads": 32, "num_hidden_layers": 16,
        "num_key_value_heads": 8, "rms_norm_eps": 1e-05,
        "rope_theta": 500000.0, "tie_word_embeddings": True,
        "vocab_size": 128256},
    # google/gemma-7b: head_dim 256, 16 query heads over 16 kv heads
    "Gemma-7B": {
        "architectures": ["GemmaForCausalLM"], "head_dim": 256,
        "hidden_act": "gelu", "hidden_size": 3072,
        "intermediate_size": 24576, "max_position_embeddings": 8192,
        "num_attention_heads": 16, "num_hidden_layers": 28,
        "num_key_value_heads": 16, "rms_norm_eps": 1e-06,
        "rope_theta": 10000.0, "vocab_size": 256000},
    # google/gemma-2b: head_dim 256, 8 query heads over one kv head
    "Gemma-2B": {
        "architectures": ["GemmaForCausalLM"], "head_dim": 256,
        "hidden_act": "gelu", "hidden_size": 2048,
        "intermediate_size": 16384, "max_position_embeddings": 8192,
        "num_attention_heads": 8, "num_hidden_layers": 18,
        "num_key_value_heads": 1, "rms_norm_eps": 1e-06,
        "rope_theta": 10000.0, "vocab_size": 256000},
}
GEMMA_7B = FAMILY_CONFIGS["Gemma-7B"]
# microsoft/Phi-3-mini-4k-instruct: head_dim 3072 / 32 = 96, which the
# card kernels do not take, and a 2047-token sliding window
PHI_3_MINI = {
    "architectures": ["Phi3ForCausalLM"], "hidden_act": "silu",
    "hidden_size": 3072, "intermediate_size": 8192,
    "max_position_embeddings": 4096, "num_attention_heads": 32,
    "num_hidden_layers": 32, "num_key_value_heads": 32,
    "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "sliding_window": 2047,
    "tie_word_embeddings": False, "vocab_size": 32064}
# families whose head_dim the kernels lack: served on the gather path
GATHER_FAMILIES = {"Phi-3-mini": PHI_3_MINI}
FAMILY_LAYERS = 2
# the Mistral prompt past its window: ten prefill chunks of <= 512 rows
WINDOW_PROMPT_TOKENS = 5000
# the Phi-3-mini prompt past its 2047-token window, inside its 4096
PHI3_LONG_PROMPT_TOKENS = 3000
# the depth of the Phi-3-mini and Gemma-7B servers: full width, 4 of
# their 32 and 28 layers (the checkpoint written, loaded and served in a
# fraction of the time, which the compiled phase's captures took; every
# layer runs the same attention)
PHI3_SERVE_LAYERS = 4
GEMMA_SERVE_LAYERS = 4


def tree_equal(torch, got: dict, want: dict) -> bool:
    """Same keys and, leaf for leaf, the same dtype, shape and bytes."""
    if sorted(got) != sorted(want):
        return False
    return all(
        tree_equal(torch, got[k], want[k]) if isinstance(want[k], dict)
        else (got[k].dtype == want[k].dtype
              and torch.equal(got[k], want[k]))
        for k in want)


def chunked_logits(torch, pa, cfg, params, n_tok: int, plain: bool,
                   window="cfg", gather=False):
    """The last row's logits of each <= 512-row prefill chunk of an
    n_tok-token prompt on the card, attention through the prefill kernel,
    (`plain`) its plain version or (`gather`) the gather path, with the
    config's window (or `window`)."""
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.ops import attention

    bs, chunk = 32, 512
    win = cfg.sliding_window if window == "cfg" else window
    pages = -(-n_tok // bs)
    shape = (cfg.num_layers, cfg.num_kv_heads, (pages + 1) * bs,
             cfg.head_dim)
    kc = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    vc = torch.zeros_like(kc)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")
    ids = torch.arange(n_tok, device="cuda") * 7919 % cfg.vocab_size
    fn = (attention.paged_prefill_attention_gather if gather
          else pa.paged_prefill_attention_plain if plain
          else pa.paged_prefill_attention)
    out = []
    for s0 in range(0, n_tok, chunk):
        t = min(chunk, n_tok - s0)
        pos = torch.arange(s0, s0 + t, device="cuda")

        def attn(q, l, k, v, s0=s0):
            return fn(q, k, v, l, table, s0, block_size=bs,
                      scale=cfg.head_dim**-0.5, window=win)

        lg, _, _ = llama.forward(
            cfg, params, ids[s0:s0 + t], pos, kc, vc, pos + bs, attn,
            logits_rows=torch.tensor([t - 1], device="cuda"))
        out.append(lg)
    return torch.cat(out).float()


def runner_log():
    """The model runner's log records from here on (a handler on its
    logger, which does not propagate)."""
    import logging

    records: list = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger(
        "production_stack_tpu_torch.engine.model_runner").addHandler(handler)
    return records


def attention_us(torch, pa, cfg, kernels: bool) -> dict:
    """Device µs of one layer's attention at `cfg`'s heads (bf16, block
    size 32, CUDA events, mean of 20 calls): a 512-row prefill chunk at
    position 512 over its 1024 keys and a decode step of 8 lanes over
    2048 keys each, on the gather path and, with `kernels`, on the
    prefill kernel, the decode kernel and the ragged kernel (the decode
    lanes packed as the runner packs a decode step)."""
    import numpy as np

    from production_stack_tpu_torch.engine.model_runner import (
        decode_segments,
    )
    from production_stack_tpu_torch.ops import attention

    bs, pages = 32, 2048 // 32
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kc = randn(1, nkv, (8 * pages + 1) * bs, d)
    vc = randn(1, nkv, (8 * pages + 1) * bs, d)
    kw = dict(block_size=bs, scale=d**-0.5, window=cfg.sliding_window)
    q_pf, q_dec = randn(512, nq, d), randn(8, nq, d)
    table = torch.arange(1, 1 + 1024 // bs, dtype=torch.int32, device="cuda")
    tables = torch.arange(1, 1 + 8 * pages, dtype=torch.int32,
                          device="cuda").view(8, pages)
    ctx = torch.full((8,), 2048, dtype=torch.int32, device="cuda")
    calls = {
        "gather prefill": lambda: attention.paged_prefill_attention_gather(
            q_pf, kc, vc, 0, table, 512, **kw),
        "gather decode": lambda: attention.paged_decode_attention_gather(
            q_dec, kc, vc, 0, tables, ctx, **kw)}
    if kernels:
        _, blk, meta = decode_segments(np.full(8, 2048, np.int32))
        blk_d = torch.from_numpy(blk).cuda()
        meta_d = torch.from_numpy(meta).cuda()
        calls.update({
            "prefill kernel": lambda: pa.paged_prefill_attention(
                q_pf, kc, vc, 0, table, 512, **kw),
            "decode kernel": lambda: pa.paged_decode_attention(
                q_dec, kc, vc, 0, tables, ctx, **kw),
            "ragged kernel": lambda: pa.ragged_paged_attention(
                q_dec, kc, vc, 0, tables, blk_d, meta_d, **kw)})
    out = {}
    for name, fn in calls.items():
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(20):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        out[name] = ev[0].elapsed_time(ev[1]) / 20 * 1e3
    return out


def print_attention_us(torch, pa, name: str, cfg, smi: str,
                       kernels: bool) -> None:
    us = attention_us(torch, pa, cfg, kernels)
    pf = ", ".join(f"{k} {v:.1f} us" for k, v in us.items()
                   if "prefill" in k)
    dec = ", ".join(f"{k} {v:.1f} us" for k, v in us.items()
                    if "prefill" not in k)
    print(f"families phase {name}: one layer's attention "
          f"({cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
          f"{cfg.head_dim}, bf16; CUDA events, mean of 20): a 512-row "
          f"prefill chunk over 1024 keys: {pf}; a decode step of 8 lanes "
          f"over 2048 keys: {dec} (the ragged kernel on the lanes packed "
          f"as the runner packs a decode step) on {smi}", flush=True)


def gather_family(torch, pa, d: Path, name: str, published: dict, i: int,
                  smi: str) -> None:
    """A family whose head_dim the kernels lack, at full width cut to
    FAMILY_LAYERS: written and read back byte for byte, logits on the
    gather path held to the CPU; a windowed one's prompt past its window
    on the gather path held to the prefill kernel's plain version on the
    card; an engine booted under auto resolves to xla (the warning in
    its log) and generates with no kernel launch; under pallas it is
    refused at boot."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.models.debug_checkpoint import (
        write_hf_checkpoint,
    )
    from production_stack_tpu_torch.models.weights import load_hf_weights

    hf = dict(published, num_hidden_layers=FAMILY_LAYERS)
    d.mkdir()
    (d / "config.json").write_text(json.dumps(hf))
    cfg = get_model_config(str(d))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10 + i)
    params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
    t0 = time.perf_counter()
    write_hf_checkpoint(str(d), hf, params)
    t1 = time.perf_counter()
    loaded = load_hf_weights(cfg, str(d), torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    print(f"families phase {name}: head_dim {cfg.head_dim}, window "
          f"{cfg.sliding_window}, {FAMILY_LAYERS} layers: wrote "
          f"{t1 - t0:.2f}s, loaded {time.perf_counter() - t1:.2f}s",
          flush=True)
    if not tree_equal(torch, loaded, params):
        fail(f"families phase {name}: the loaded params differ from the "
             "written ones")
    del params
    card_vs_cpu(torch, pa, f"families phase {name} (gather path)", cfg,
                loaded, gather=True)
    if cfg.sliding_window:
        n_tok = PHI3_LONG_PROMPT_TOKENS
        got = chunked_logits(torch, pa, cfg, loaded, n_tok, plain=False,
                             gather=True)
        ref = chunked_logits(torch, pa, cfg, loaded, n_tok, plain=True)
        torch.cuda.synchronize()
        top = float(ref.abs().max())
        rel = float((got - ref).abs().max()) / top
        print(f"families phase {name}: a {n_tok}-token prompt past the "
              f"{cfg.sliding_window}-token window, last rows of "
              f"{got.shape[0]} chunks, gather path vs the prefill kernel's "
              f"plain version on the card max|d|/max|ref|={rel:.3e} "
              f"tol={LOGIT_REL_TOL}", flush=True)
        if not (torch.isfinite(got).all() and rel <= LOGIT_REL_TOL):
            fail(f"families phase {name}: windowed prompt logits differ "
                 f"by {rel:.3e}")
    del loaded
    release(torch)
    print_attention_us(torch, pa, name, cfg, smi, kernels=False)
    records = runner_log()
    pa.reset_launch_counts()
    eng = LLMEngine(EngineConfig(
        model=str(d), tokenizer="byte", device="cuda", block_size=32,
        num_kv_blocks=64, max_num_seqs=4, seed=SEED))
    want = (f"attention impl: xla (head_dim {cfg.head_dim} not in "
            f"{pa.KERNEL_HEAD_DIMS})")
    warned = [r.getMessage() for r in records if r.levelname == "WARNING"]
    if eng.runner.attention_impl != "xla" or want not in warned:
        fail(f"families phase {name}: auto resolved to "
             f"{eng.runner.attention_impl}, warnings {warned}")
    outs = eng.generate(
        [[(5 * j + i) % 250 + 1 for j in range(n)] for n in (9, 77)],
        SamplingParams(max_tokens=8, temperature=0, ignore_eos=True))
    torch.cuda.synchronize()
    if [len(o.token_ids) for o in outs] != [8, 8]:
        fail(f"families phase {name}: engine on the checkpoint gave "
             f"{[o.token_ids for o in outs]}")
    if any(pa.launch_counts().values()):
        fail(f"families phase {name}: the gather path launched kernels "
             f"{pa.launch_counts()}")
    print(f"families phase {name}: engine booted under auto logged "
          f"'{want}', greedy tokens {[o.token_ids for o in outs]}, no "
          f"kernel launch, on {smi}", flush=True)
    del eng
    release(torch)
    try:
        LLMEngine(EngineConfig(model=str(d), tokenizer="byte",
                               device="cuda", num_kv_blocks=64,
                               attention_impl="pallas"))
    except ValueError as e:
        if f"head_dim {cfg.head_dim}" not in str(e):
            fail(f"families phase {name}: refused without naming its "
                 f"head_dim: {e}")
        print(f"families phase {name}: refused at boot under pallas: {e}",
              flush=True)
    else:
        fail(f"families phase {name}: head_dim {cfg.head_dim} booted on "
             "the card under pallas")


def families_phase(torch, pa, smi: str) -> dict:
    """HF checkpoints of published configs at full width, cut to 2
    layers: written from seeded params (qkv biases drawn too), read back
    byte for byte through models/weights.py onto the card, logits held
    to the CPU, a short greedy run through an engine booted on the
    directory under auto (pallas, no warning, launches held to 2 a
    forward); the Mistral prompt past its window held to the plain
    attention on the card; Gemma-7B and Gemma-2B (head_dim 256) also
    through the composed round's prefill and decode kernels, and one
    layer's attention timed on the kernels beside the gather path;
    Phi-3-mini (head_dim 96) on the gather path (gather_family). Returns
    the head_dim-256 engines' launches."""
    import shutil
    import tempfile

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.models.debug_checkpoint import (
        write_hf_checkpoint,
    )
    from production_stack_tpu_torch.models.weights import load_hf_weights

    t_phase = time.perf_counter()
    counts = {"ragged": 0, "prefill": 0, "decode": 0}
    (REPO / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="families-", dir=REPO / "build"))
    try:
        for i, (name, published) in enumerate(FAMILY_CONFIGS.items()):
            d = root / name
            d.mkdir()
            hf = dict(published, num_hidden_layers=FAMILY_LAYERS)
            (d / "config.json").write_text(json.dumps(hf))
            cfg = get_model_config(str(d))
            g_heads = cfg.num_heads // cfg.num_kv_heads
            gen = torch.Generator(device="cuda").manual_seed(SEED + i)
            params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
            if cfg.qkv_bias:
                for b in ("bq", "bk", "bv"):
                    params["layers"][b] = (torch.randn(
                        params["layers"][b].shape, generator=gen,
                        device="cuda") * 0.5).bfloat16()
            t0 = time.perf_counter()
            write_hf_checkpoint(str(d), hf, params)
            t1 = time.perf_counter()
            loaded = load_hf_weights(cfg, str(d), torch.bfloat16, "cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            print(f"families phase {name}: head_dim {cfg.head_dim}, g "
                  f"{g_heads}, window {cfg.sliding_window}, qkv bias "
                  f"{cfg.qkv_bias}, tied {cfg.tie_word_embeddings}, "
                  f"{FAMILY_LAYERS} layers: wrote {t1 - t0:.2f}s, loaded "
                  f"{t2 - t1:.2f}s", flush=True)
            if not tree_equal(torch, loaded, params):
                fail(f"families phase {name}: the loaded params differ "
                     "from the written ones")
            del params
            card_vs_cpu(torch, pa, f"families phase {name}", cfg, loaded)
            if cfg.sliding_window:
                kern = chunked_logits(torch, pa, cfg, loaded,
                                      WINDOW_PROMPT_TOKENS, plain=False)
                plain = chunked_logits(torch, pa, cfg, loaded,
                                       WINDOW_PROMPT_TOKENS, plain=True)
                full = chunked_logits(torch, pa, cfg, loaded,
                                      WINDOW_PROMPT_TOKENS, plain=False,
                                      window=None)
                torch.cuda.synchronize()
                top = float(plain.abs().max())
                rel = float((kern - plain).abs().max()) / top
                rel_full = float((full[-1] - plain[-1]).abs().max()) / top
                print(f"families phase {name}: a {WINDOW_PROMPT_TOKENS}-"
                      f"token prompt past the {cfg.sliding_window}-token "
                      f"window, last rows of {kern.shape[0]} chunks, "
                      f"kernel vs plain on the card max|d|/max|ref|="
                      f"{rel:.3e} tol={LOGIT_REL_TOL} (the same kernel "
                      f"without the window moves the last chunk's row by "
                      f"{rel_full:.3e})", flush=True)
                if not (torch.isfinite(kern).all() and rel <= LOGIT_REL_TOL):
                    fail(f"families phase {name}: windowed prompt logits "
                         f"differ by {rel:.3e}")
            del loaded
            release(torch)
            if cfg.head_dim == 256:
                print_attention_us(torch, pa, name, cfg, smi, kernels=True)
            # the default engine (unified ragged rounds) and, at head_dim
            # 256, the composed round (--no-ragged-kernel: the prefill and
            # decode kernels), each booted under auto on the directory
            modes = {"ragged": {}}
            if cfg.head_dim == 256:
                modes["composed"] = {"ragged_kernel": False}
            streams = {}
            for mode, over in modes.items():
                records = runner_log()
                eng = LLMEngine(EngineConfig(
                    model=str(d), tokenizer="byte", device="cuda",
                    block_size=32, num_kv_blocks=64, max_num_seqs=4,
                    seed=SEED, **over))
                runs0 = dict(eng.runner.dispatch_counts)
                pa.reset_launch_counts()
                outs = eng.generate(
                    [[(5 * j + i) % 250 + 1 for j in range(n)]
                     for n in (9, 77)],
                    SamplingParams(max_tokens=8, temperature=0,
                                   ignore_eos=True))
                torch.cuda.synchronize()
                launches = pa.launch_counts()
                if [len(o.token_ids) for o in outs] != [8, 8]:
                    fail(f"families phase {name}: engine on the checkpoint "
                         f"gave {[o.token_ids for o in outs]}")
                warned = [r.getMessage() for r in records
                          if r.levelname == "WARNING"]
                if (eng.runner.attention_impl != "pallas"
                        or any("attention impl" in w for w in warned)):
                    fail(f"families phase {name}: auto resolved to "
                         f"{eng.runner.attention_impl}, warnings {warned}")
                runs = {k: v - runs0[k]
                        for k, v in eng.runner.dispatch_counts.items()}
                check_launches(f"families phase {name} ({mode})", launches,
                               runs, layers=FAMILY_LAYERS, impl=mode)
                check_pool(f"families phase {name} ({mode})", eng.runner,
                           smi)
                if cfg.head_dim == 256:
                    for k in counts:
                        counts[k] += launches[k]
                streams[mode] = [o.token_ids for o in outs]
                print(f"families phase {name}: {mode} engine booted on the "
                      f"directory under auto (pallas, no warning), greedy "
                      f"tokens {streams[mode]}", flush=True)
                del eng
                release(torch)
            if "composed" in streams:
                same = sum(a == b for a, b in zip(streams["ragged"],
                                                  streams["composed"]))
                print(f"families phase {name}: {same}/2 greedy streams of "
                      "the composed round equal to the ragged kernel's "
                      "(printed, not held: no near-tie tolerance is "
                      "measured at 2 layers)", flush=True)
            shutil.rmtree(d)
            release(torch)
        for i, (name, published) in enumerate(GATHER_FAMILIES.items()):
            gather_family(torch, pa, root / name, name, published, i, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"families phase: {time.perf_counter() - t_phase:.1f}s; head_dim "
          f"256 engines launched {counts}", flush=True)
    return counts


# -- checkpoint phase ----------------------------------------------------------
class Stream:
    """A greedy stream read over HTTP: token ids (vLLM's
    return_tokens_as_token_ids) for near_tie_check."""

    def __init__(self, token_ids):
        self.token_ids = token_ids


def lora_weights(torch, cfg, rank: int, seed: int) -> dict:
    """Seeded adapter arrays for q/k/v/o, ours (L, in, r) / (L, r, out),
    bf16: with scaling 1 each moves its projection by about half the
    base projection's spread (A ~ N(0, 1/in), B ~ N(0, 1/(4 r)))."""
    g = torch.Generator().manual_seed(seed)
    h, L = cfg.hidden_size, cfg.num_layers
    dims = {"wq": (h, cfg.q_size), "wk": (h, cfg.kv_size),
            "wv": (h, cfg.kv_size), "wo": (cfg.q_size, h)}
    w = {}
    for t, (din, dout) in dims.items():
        w[f"{t}_A"] = (torch.randn((L, din, rank), generator=g)
                       * din**-0.5).bfloat16()
        w[f"{t}_B"] = (torch.randn((L, rank, dout), generator=g)
                       * 0.5 * rank**-0.5).bfloat16()
    return w


def merged_params(torch, params: dict, w: dict) -> dict:
    """The base params with W + A @ B (scaling 1) in every target,
    summed in f32 and rounded to bf16 once."""
    layers = dict(params["layers"])
    for t in ("wq", "wk", "wv", "wo"):
        delta = torch.bmm(w[f"{t}_A"].cuda().float(),
                          w[f"{t}_B"].cuda().float())
        layers[t] = (layers[t].float() + delta).bfloat16()
    return {**params, "layers": layers}


def all_row_logits(torch, pa, cfg, params, ids, lora=None, slot=None,
                   return_hidden: bool = False):
    """f32 logits of every row of one prompt (one prefill chunk on the
    prefill kernel), optionally with one adapter slot; the final-norm
    hidden rows instead with `return_hidden`."""
    from production_stack_tpu_torch.models import llama

    bs, T = 32, len(ids)
    pages = -(-T // bs)
    shape = (cfg.num_layers, cfg.num_kv_heads, (pages + 1) * bs,
             cfg.head_dim)
    kc = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    vc = torch.zeros_like(kc)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")
    pos = torch.arange(T, device="cuda")

    def attn(q, l, k, v):
        return pa.paged_prefill_attention(q, k, v, l, table, 0,
                                          block_size=bs,
                                          scale=cfg.head_dim**-0.5)

    kw = {} if lora is None else {"lora": lora, "lora_slots": slot}
    lg, _, _ = llama.forward(cfg, params, torch.tensor(ids, device="cuda"),
                             pos, kc, vc, pos + bs, attn, logits_rows=pos,
                             return_hidden=return_hidden, **kw)
    return lg


# the checkpoint phase's long prompts: three prefill chunks each
LORA_LONG_PROMPT_TOKENS = 1100
# the checkpoint phase's depth: full width, 8 of the 3B's 28 layers (the
# write, the load, the LoRA server and its four reference engines in a
# fraction of the time, which the sync phase's composed sweep takes)
CKPT_LAYERS = 8


def checkpoint_phase(torch, pa, gap_tol: float, smi: str) -> dict:
    """llama-3.2-3b at full width and CKPT_LAYERS of its 28 layers as an
    HF checkpoint: written
    from seeded bf16 params (sharded as HF shards it), read back byte for
    byte, served by the CLI with --enable-lora; two PEFT adapters (rank
    16 and 8) loaded over HTTP; base and adapter requests sent at once,
    so prefill chunks and decode rows of different slots share ragged
    rounds. The base streams are held to an engine without LoRA, each
    adapter's to an engine on merged weights, under the near-tie rule;
    one in-process decode step shows a base lane's logits unchanged to
    the bit by the adapters beside it. Returns the served run's kernel
    launches."""
    import dataclasses
    import shutil
    import tempfile
    import urllib.error

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.lora import write_peft_adapter
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.models.debug_checkpoint import (
        hf_config_of,
        write_hf_checkpoint,
    )
    from production_stack_tpu_torch.models.weights import load_hf_weights

    cfg = dataclasses.replace(get_model_config("llama-3.2-3b"),
                              num_layers=CKPT_LAYERS)
    (REPO / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ckpt-", dir=REPO / "build"))
    ckdir = str(root / "llama-3.2-3b")
    proc = None
    try:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
        t0 = time.perf_counter()
        # HF shards Llama-3.2-3B at <= 5 GB a file
        shards = write_hf_checkpoint(ckdir, hf_config_of(cfg), params,
                                     shard_bytes=5 * 10**9)
        t1 = time.perf_counter()
        loaded = load_hf_weights(get_model_config(ckdir), ckdir,
                                 torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        size = sum(os.path.getsize(p) for p in shards)
        print(f"checkpoint phase: wrote {len(shards)} shards, "
              f"{size / 1e9:.2f} GB, in {t1 - t0:.2f}s; load_hf_weights "
              f"onto the card in {load_s:.2f}s ({size / load_s / 1e9:.2f} "
              f"GB/s) on {smi}", flush=True)
        if not tree_equal(torch, loaded, params):
            fail("checkpoint phase: the loaded params differ from the "
                 "written ones")
        del loaded, params
        release(torch)

        ranks = {"ad16": 16, "ad8": 8}
        weights = {name: lora_weights(torch, cfg, r, SEED + r)
                   for name, r in ranks.items()}
        for name, r in ranks.items():
            write_peft_adapter(str(root / name), weights[name],
                               lora_alpha=float(r))  # scaling 1

        port = free_port()
        log_path = REPO / "build" / "chip_smoke_lora_serve.log"
        t0 = time.perf_counter()
        proc = start_server(port, log_path, model=ckdir, extra=(
            "--enable-lora", "--max-loras", "4", "--max-lora-rank", "16",
            "--num-scheduler-steps", "8"))
        boot = wait_healthy("checkpoint phase", proc, port, log_path, t0)
        print(f"checkpoint phase: --model <dir> --enable-lora server "
              f"healthy {boot:.1f}s after start (the load included) on "
              f"{smi}", flush=True)
        for name in ranks:
            st, body = http(port, "/v1/load_lora_adapter", {
                "lora_name": name, "lora_path": str(root / name)})
            if st != 200:
                fail(f"checkpoint phase: loading {name}: {body}")
        ids = [c["id"] for c in json.loads(http(port, "/v1/models")[1])[
            "data"]]
        if ids != [ckdir, "ad16", "ad8"]:
            fail(f"checkpoint phase: /v1/models lists {ids}")

        models = [None, "ad16", "ad8"]
        short = {m: [(9 * i + 5 * j) % 250 + 1 for j in range(20 + 7 * i)]
                 for i, m in enumerate(models)}
        long = {m: [(11 * i + 3 * j) % 250 + 1
                    for j in range(LORA_LONG_PROMPT_TOKENS)]
                for i, m in enumerate(models)}
        n_short, n_long = 40, 8

        def completion(ids, n, model):
            body = {"prompt": ids, "max_tokens": n, "temperature": 0,
                    "ignore_eos": True, "logprobs": 1,
                    "return_tokens_as_token_ids": True}
            if model is not None:
                body["model"] = model
            st, text = http(port, "/v1/completions", body)
            r = json.loads(text)
            toks = r["choices"][0]["logprobs"]["tokens"]
            if st != 200 or len(toks) != n:
                fail(f"checkpoint phase: bad completion {text[:300]}")
            return Stream([int(t.split(":")[1]) for t in toks])

        http(port, "/debug/kernel_launches", method="DELETE")
        rounds0 = metric(port, "tpu:ragged_rounds_total")
        gen0 = metric(port, "vllm:generation_tokens_total")
        t1 = time.perf_counter()
        with ThreadPoolExecutor(6) as ex:
            lanes = {m: ex.submit(completion, short[m], n_short, m)
                     for m in models}
            while metric(port, "vllm:generation_tokens_total") < gen0 + 3:
                if any(f.done() for f in lanes.values()):
                    fail("checkpoint phase: a decoding lane finished "
                         "before the long prompts were sent")
                time.sleep(0.01)
            longs = {m: ex.submit(completion, long[m], n_long, m)
                     for m in models}
            served = {("short", m): f.result() for m, f in lanes.items()}
            served.update({("long", m): f.result()
                           for m, f in longs.items()})
        rounds = metric(port, "tpu:ragged_rounds_total") - rounds0
        report = json.loads(http(port, "/debug/kernel_launches")[1])
        print(f"checkpoint phase: 3 short + 3 long requests over base, "
              f"ad16 and ad8 in {time.perf_counter() - t1:.2f}s, "
              f"{rounds:.0f} mixed rounds; dispatches "
              f"{report['dispatches']}, launches {report['launches']}",
              flush=True)
        if not rounds > 0:
            fail("checkpoint phase: no mixed round served the adapters")
        check_launches("checkpoint phase", report["launches"],
                       report["dispatches"], layers=CKPT_LAYERS)
        st, body = http(port, "/v1/unload_lora_adapter",
                        {"lora_name": "ad8"})
        try:
            http(port, "/v1/completions", {"prompt": "x", "max_tokens": 2,
                                           "model": "ad8"})
            fail("checkpoint phase: a request for an unloaded adapter "
                 "was served")
        except urllib.error.HTTPError as e:
            if e.code != 404:
                fail(f"checkpoint phase: unloaded adapter gave {e.code}")
        print(f"checkpoint phase: ad8 unloaded ({st}); a request naming it "
              "gets 404", flush=True)
        stop_server(proc)
        proc = None

        # references in process, on the same checkpoint
        sp = SamplingParams(max_tokens=n_short, temperature=0,
                            ignore_eos=True, logprobs=2)
        sp_long = SamplingParams(max_tokens=n_long, temperature=0,
                                 ignore_eos=True, logprobs=2)
        base_cfg = dict(model=ckdir, tokenizer="byte", device="cuda",
                        block_size=32, num_kv_blocks=512, max_num_seqs=8,
                        seed=SEED)

        def reference(eng, model):
            return [eng.generate([short[model]], sp)[0],
                    eng.generate([long[model]], sp_long)[0]]

        lora_eng = LLMEngine(EngineConfig(**base_cfg, enable_lora=True,
                                          max_loras=4, max_lora_rank=16))
        for name in ranks:
            lora_eng.load_lora(name, str(root / name))
        r = lora_eng.runner
        base_params = r.params
        # one decode step, lanes [base, ad16, base, ad8], with and without
        # the adapters: the base lanes' logits must not move by a bit
        prompts = [short[None], short["ad16"], long[None][:300],
                   short["ad8"]]
        tables, nxt = [], 1
        for p in prompts:
            n = -(-(len(p) + 1) // 32)
            tables.append(list(range(nxt, nxt + n)))
            nxt += n
        for p, tb in zip(prompts, tables):
            r.prefill(p, 0, tb, len(p))
        step = ([7, 7, 7, 7], [len(p) for p in prompts], tables,
                [len(p) + 1 for p in prompts])
        with_ad = r.decode(*step, lora_slots=[0, 1, 0, 2])[:4]
        without = r.decode(*step)[:4]
        moved = float((with_ad[[1, 3]] - without[[1, 3]]).abs().max())
        exact = torch.equal(with_ad[[0, 2]], without[[0, 2]])
        print(f"checkpoint phase: one decode step with lanes [base, ad16, "
              f"base, ad8]: base lanes bit-equal without the adapters "
              f"{exact}; the adapters move their lanes' logits by up to "
              f"{moved:.3f}", flush=True)
        if not exact or not moved > 0:
            fail("checkpoint phase: slot 0 did not add an exact zero, or "
                 "an adapter changed nothing")
        probe = long[None][:256]
        tols = {}
        for slot, name in enumerate(ranks, start=1):
            merged = merged_params(torch, base_params, weights[name])
            via_lora = all_row_logits(torch, pa, cfg, base_params, probe,
                                      r.lora_manager.buffers, slot)
            via_merge = all_row_logits(torch, pa, cfg, merged, probe)
            tols[name] = float((via_lora - via_merge).abs().max())
            del via_lora, via_merge
            m_eng = LLMEngine(EngineConfig(**base_cfg), params=merged)
            del merged
            refs = reference(m_eng, name)
            del m_eng
            release(torch)
            tol = max(gap_tol, tols[name])
            n_same = near_tie_check(
                f"checkpoint phase ({name} vs merged weights)", refs,
                [served["short", name], served["long", name]], tol)
            print(f"checkpoint phase: {name}: {n_same}/2 served greedy "
                  f"streams equal to the merged-weight engine's; LoRA vs "
                  f"merged forward over 256 rows max|dlogit| "
                  f"{tols[name]:.4f}, near-tie tolerance {tol:.4f}",
                  flush=True)
        del lora_eng, r, base_params
        release(torch)
        base_eng = LLMEngine(EngineConfig(**base_cfg))
        refs = reference(base_eng, None)
        del base_eng
        n_same = near_tie_check(
            "checkpoint phase (base vs no-LoRA engine)", refs,
            [served["short", None], served["long", None]], gap_tol)
        print(f"checkpoint phase: base: {n_same}/2 served greedy streams "
              "equal to the engine without LoRA's", flush=True)
    finally:
        if proc is not None:
            stop_server(proc)
        shutil.rmtree(root, ignore_errors=True)
        release(torch)
    return report["launches"]


# -- KV phase ------------------------------------------------------------------
KV_PROMPT_TOKENS = 1500   # 46 full 32-token blocks
PD_PROMPT_TOKENS = 1100   # 34 full blocks


class HttpStream:
    """A greedy stream read over HTTP with its top-2 logprobs, shaped as
    near_tie_check reads a RequestOutput (token ids from vLLM's
    return_tokens_as_token_ids)."""

    def __init__(self, choice: dict):
        lp = choice["logprobs"]
        self.token_ids = [int(t.split(":")[1]) for t in lp["tokens"]]
        self.logprobs = [
            {"top_logprobs": [{"logprob": v} for v in
                              sorted(top.values(), reverse=True)]}
            for top in lp["top_logprobs"]]


def kv_counters(what: str, samples: dict, want: dict) -> None:
    """tpu:kv_* samples (from /metrics or EngineMetrics.render) against
    the values the phase requires; the restore and export fallbacks of
    the JAX engine's degradations must read 0, so the card path is the
    one that ran."""
    got = {k: samples[k][0][1] if k in samples else None for k in want}
    print(f"{what}: {got}", flush=True)
    bad = {k: v for k, v in got.items() if v != want[k]}
    if bad:
        fail(f"{what}: {bad}, want {want}")


def kv_phase(torch, pa, gap_tol: float, smi: str,
             model: str = "llama-3.2-3b", device: str = "cuda") -> dict:
    """The port's KV export, import, tiers, PD pull and shared cache
    server on `model`: main hands it the 3B at full width and CKPT_LAYERS
    layers as a checkpoint (bf16, random weights), which its CLI engines
    serve. `model` and `device` also serve a dry run of the phase's logic
    on a CPU with a tiny model."""
    import gc
    import shutil

    from production_stack_tpu_torch.engine.block_manager import (
        iter_chain_hashes,
    )
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.metrics import EngineMetrics
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.kv import offload
    from production_stack_tpu_torch.kv.remote import CacheClient
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.ops.attention import block_table_slots

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    bs = 32
    mc = get_model_config(model)
    layers, nkv, d = mc.num_layers, mc.num_kv_heads, mc.head_dim
    block_bytes = 2 * layers * nkv * bs * d * 2  # bf16 wire block
    engine_kw = dict(model=model, tokenizer="byte", device=device,
                     block_size=bs, num_kv_blocks=100, max_num_seqs=4,
                     seed=SEED, kv_restore_wait_s=30.0)
    server_args = () if device == "cuda" else ("--device", device)
    prompt = [(17 * j + 5) % 250 + 1 for j in range(KV_PROMPT_TOKENS)]
    churn = [[(13 * j + 7 * i + 3) % 250 + 1
              for j in range(KV_PROMPT_TOKENS)] for i in range(1, 4)]
    n_full = KV_PROMPT_TOKENS // bs
    sp = SamplingParams(max_tokens=16, temperature=0, ignore_eos=True,
                        logprobs=2)
    root = REPO / "build" / "chip_smoke_kv"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cs_port = free_port()
    cs_log = REPO / "build" / "chip_smoke_cache_server.log"
    with open(cs_log, "wb") as log:
        cache_srv = subprocess.Popen(
            [sys.executable, "-m",
             "production_stack_tpu_torch.kv.cache_server",
             "--host", "127.0.0.1", "--port", str(cs_port),
             "--capacity-gb", "4"],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    procs = []
    counts = {}
    try:
        client = CacheClient("127.0.0.1", cs_port, timeout=30)
        t0 = time.perf_counter()
        while not client.ping():
            if cache_srv.poll() is not None or time.perf_counter() - t0 > 60:
                fail(f"KV phase: cache server not up:\n{log_tail(cs_log)}")
            time.sleep(0.2)
        print(f"KV phase: cache server (python -m production_stack_tpu_"
              f"torch.kv.cache_server) up on :{cs_port}", flush=True)

        # (a) runner: export, import, read back, serialize; hash cost
        eng = LLMEngine(EngineConfig(
            **engine_kw, cpu_offload_bytes=24 * block_bytes,
            disk_offload_dir=str(root / "disk"),
            remote_cache_url=f"127.0.0.1:{cs_port}"))
        pa.reset_launch_counts()
        first = eng.generate([prompt], sp)[0]
        bm, r = eng.block_manager, eng.runner
        hashes = bm.block_hashes_for(prompt, 0)
        bids = [bm.cached_blocks[h] for h in hashes]
        free = [b for b in range(1, 100) if b not in bm.cached_blocks.values()
                and bm.blocks[b].ref_count == 0][:n_full]
        if len(bids) != n_full or len(free) != n_full:
            fail(f"KV phase: {len(bids)} cached and {len(free)} free blocks")
        nbytes = n_full * block_bytes
        exp_s, imp_s, pin_s = [], [], []

        def ms(ts):
            return [round(t * 1e3, 2) for t in ts]

        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            data = r.export_blocks(bids)
            exp_s.append(time.perf_counter() - t0)
            # from pageable host memory, as the tiers hand blocks back
            # (the import pins a copy), and from the pinned export
            host = data.clone()
            for src, out in ((host, imp_s), (data, pin_s)):
                t0 = time.perf_counter()
                r.import_blocks(free, src)
                sync()
                out.append(time.perf_counter() - t0)
            del host
        slots = block_table_slots(torch.tensor(bids), bs).to(device)
        direct = torch.stack([
            c.index_select(2, slots).view(layers, nkv, n_full, bs, d)
            .transpose(1, 2) for c in (r.k_cache, r.v_cache)]).cpu()
        back = r.export_blocks(free)
        wire = offload.deserialize_block(offload.serialize_block(data))
        ok = (torch.equal(data, direct) and torch.equal(back, data)
              and torch.equal(r.export_blocks(bids), data)
              and torch.equal(wire, data))
        print(f"KV phase (a): {n_full} blocks of the {KV_PROMPT_TOKENS}-"
              f"token prompt ({nbytes / 2**20:.1f} MiB, wire layout "
              f"{tuple(data.shape)} {data.dtype}) exported and imported "
              f"into {n_full} other blocks: read back byte-equal {ok}; "
              f"export (gather + pinned d2h) {ms(exp_s)} ms = best "
              f"{nbytes / min(exp_s) / 1e9:.2f} GB/s, import from pageable "
              f"memory (pin copy + h2d + index_copy_) {ms(imp_s)} ms = best "
              f"{nbytes / min(imp_s) / 1e9:.2f} GB/s, from the pinned "
              f"export {ms(pin_s)} ms = best "
              f"{nbytes / min(pin_s) / 1e9:.2f} GB/s (host clock) on {smi}",
              flush=True)
        if not ok:
            fail("KV phase (a): exported/imported blocks differ")
        t0 = time.perf_counter()
        for _ in range(20):
            list(iter_chain_hashes(prompt, bs))
        per_prompt = (time.perf_counter() - t0) / 20
        print(f"KV phase (a): xxh64 chain hash {per_prompt / n_full * 1e6:.1f}"
              f" us a {bs}-token block, {per_prompt * 1e3:.3f} ms a "
              f"{KV_PROMPT_TOKENS}-token prompt (host clock)", flush=True)
        del data, back, wire, direct

        # (b) offload engine: churn evicts the prompt, restore from tiers
        def drain(e):
            """Until the offload worker has stored every export (the
            restore below then measures itself, not a queue)."""
            t0 = time.perf_counter()
            def busy():
                pending = next(t for t in e.offload.stats()
                               if t["tier"] == "pending")
                return (e.offload.export_backlog() or pending["blocks"]
                        or not e.offload._q.empty())

            while busy() and time.perf_counter() - t0 < 120:
                time.sleep(0.01)

        drain(eng)
        for c in churn:
            eng.generate([c], SamplingParams(max_tokens=4, temperature=0,
                                             ignore_eos=True))
            drain(eng)
        resident = sum(bm.contains_hash(h) for h in hashes)
        tiers = {t.name: len(t.hashes()) for t in eng.offload.tiers}
        local = [h for h in hashes if any(t.contains(h)
                                          for t in eng.offload.tiers)]
        r0 = eng._kv_restore_blocks_total
        restored = eng.generate([prompt], sp)[0]
        sync()
        # where a restore's time goes: the tier reads on the host, then
        # the batch's stack, pin copy, h2d and scatter
        t0 = time.perf_counter()
        blocks = [eng.offload.get(h) for h in hashes]
        t1 = time.perf_counter()
        r.import_blocks(free, torch.stack(blocks, dim=2))
        sync()
        t2 = time.perf_counter()
        print(f"KV phase (b): the prompt's {n_full} blocks read from the "
              f"tiers on the host in {(t1 - t0) * 1e3:.1f} ms, stacked and "
              f"imported in {(t2 - t1) * 1e3:.1f} ms (host clock)",
              flush=True)
        del blocks
        ttft = [o.metrics.first_token_time - o.metrics.arrival_time
                for o in (first, restored)]
        restore_s = eng._kv_restore_seconds_total
        samples, _ = parse_metrics(EngineMetrics("m").render(eng.stats()))
        counters = eng.offload.counters()
        print(f"KV phase (b): after churn {resident} of the prompt's "
              f"{n_full} blocks resident, tiers hold {tiers}; restored "
              f"{eng._kv_restore_blocks_total - r0} blocks in "
              f"{restore_s:.4f} s (enqueue -> landed); tier counters "
              f"{counters}; TTFT cold {ttft[0] * 1e3:.1f} ms, restored "
              f"{ttft[1] * 1e3:.1f} ms (host clock) on {smi}", flush=True)
        if resident or len(local) != n_full:
            fail(f"KV phase (b): {resident} blocks still resident, "
                 f"{len(local)} in the tiers")
        kv_counters("KV phase (b) metrics", samples, {
            "tpu:kv_restore_blocks_total": float(n_full),
            "tpu:kv_restore_fallbacks_total": 0.0,
            "tpu:kv_export_sync_fallbacks_total": 0.0})
        n_same = near_tie_check("KV phase (b)", [first], [restored], gap_tol)
        check_launches("KV phase (b)", pa.launch_counts(),
                       r.dispatch_counts, layers=layers)
        counts["offload"] = pa.launch_counts()
        remote = eng.offload.remote
        remote.flush()
        print(f"KV phase (b): {n_same}/1 restored greedy stream equal to "
              f"the cold one; shared cache write-through: "
              f"{remote.counters()}", flush=True)
        if client.lookup(hashes) != n_full:
            fail("KV phase (b): the cache server does not hold the prompt")
        eng.shutdown()
        del eng, r, bm
        gc.collect()
        release(torch)

        # (c) PD over HTTP: prefill serves KV, decode pulls it
        kv_port, pf_port, dc_port = free_port(), free_port(), free_port()
        pf_log = REPO / "build" / "chip_smoke_prefill_serve.log"
        dc_log = REPO / "build" / "chip_smoke_decode_serve.log"
        t0 = time.perf_counter()
        pf = start_server(pf_port, pf_log, model, extra=server_args + (
            "--kv-role", "prefill",
            "--kv-transfer-listen", f"127.0.0.1:{kv_port}"))
        procs.append(pf)
        dc = start_server(dc_port, dc_log, model, extra=server_args + (
            "--kv-role", "kv_consumer", "--kv-peer", f"127.0.0.1:{kv_port}"))
        procs.append(dc)
        for name, proc, port, log in (("prefill", pf, pf_port, pf_log),
                                      ("decode", dc, dc_port, dc_log)):
            wait_healthy(f"KV phase (c) {name}", proc, port, log, t0)
            role = json.loads(http(port, "/v1/models")[1])["data"][0].get(
                "kv_role")
            if role != name:
                fail(f"KV phase (c): the {name} server's card says {role}")
            http(port, "/debug/kernel_launches", method="DELETE")
        ids = [(7 * j + 11) % 250 + 1 for j in range(PD_PROMPT_TOKENS)]
        n_pd = PD_PROMPT_TOKENS // bs

        def completion(port, n):
            st, text = http(port, "/v1/completions", {
                "prompt": ids, "max_tokens": n, "temperature": 0,
                "ignore_eos": True, "logprobs": 2,
                "return_tokens_as_token_ids": True})
            choice = json.loads(text)["choices"][0]
            if st != 200 or len(choice["logprobs"]["tokens"]) != n:
                fail(f"KV phase (c): bad completion {text[:300]}")
            return HttpStream(choice)

        t1 = time.perf_counter()
        completion(pf_port, 1)  # the pd policy's phase 1
        t2 = time.perf_counter()
        pulled = completion(dc_port, 16)
        t3 = time.perf_counter()
        own = completion(pf_port, 16)
        print(f"KV phase (c): {PD_PROMPT_TOKENS}-token prompt, prefill "
              f"(max_tokens 1) {t2 - t1:.3f}s, decode with the pull "
              f"{t3 - t2:.3f}s (host clock)", flush=True)
        for name, port in (("prefill", pf_port), ("decode", dc_port)):
            samples, _ = parse_metrics(http(port, "/metrics")[1])
            want = {"tpu:kv_restore_fallbacks_total": 0.0,
                    "tpu:kv_export_sync_fallbacks_total": 0.0}
            if name == "decode":
                want.update({"tpu:kv_peer_hits_total": float(n_pd),
                             "tpu:kv_peer_fallbacks_total": 0.0,
                             "tpu:kv_restore_blocks_total": float(n_pd)})
            kv_counters(f"KV phase (c) {name} server", samples, want)
            report = json.loads(http(port, "/debug/kernel_launches")[1])
            check_launches(f"KV phase (c) {name} server",
                           report["launches"], report["dispatches"],
                           layers=layers)
            counts[name] = report["launches"]
        n_same = near_tie_check("KV phase (c)", [own], [pulled], gap_tol)
        print(f"KV phase (c): {n_same}/1 pulled greedy stream equal to the "
              "prefill server's own", flush=True)
        for proc in (dc, pf):  # decode first: it holds the peer socket
            stop_server(proc)
        procs.clear()
        release(torch)

        # (d) a second engine restores the prompt from the cache server
        eng = LLMEngine(EngineConfig(
            **engine_kw, remote_cache_url=f"127.0.0.1:{cs_port}"))
        pa.reset_launch_counts()
        again = eng.generate([prompt], sp)[0]
        t0 = time.perf_counter()
        pulled = client.get_chain(hashes)
        print(f"KV phase (d): one get_chain of {len(pulled)} blocks from "
              f"the cache server in {(time.perf_counter() - t0) * 1e3:.1f}"
              " ms (host clock: serialize, loopback, deserialize)",
              flush=True)
        del pulled
        samples, _ = parse_metrics(EngineMetrics("m").render(eng.stats()))
        kv_counters("KV phase (d) metrics", samples, {
            "tpu:kv_remote_hits_total": float(n_full),
            "tpu:kv_restore_blocks_total": float(n_full),
            "tpu:kv_restore_fallbacks_total": 0.0,
            "tpu:kv_export_sync_fallbacks_total": 0.0})
        check_launches("KV phase (d)", pa.launch_counts(),
                       eng.runner.dispatch_counts, layers=layers)
        counts["remote"] = pa.launch_counts()
        n_same = near_tie_check("KV phase (d)", [first], [again], gap_tol)
        m = again.metrics
        print(f"KV phase (d): a second engine restored {n_full} blocks from "
              f"the cache server in {eng._kv_restore_seconds_total:.4f} s, "
              f"TTFT {(m.first_token_time - m.arrival_time) * 1e3:.1f} ms; "
              f"{n_same}/1 greedy stream equal to the first engine's; "
              f"cache server {client.stats().get('blocks')} blocks",
              flush=True)
        eng.shutdown()
        del eng
        gc.collect()
        release(torch)
        client.close()
    finally:
        for proc in procs:
            stop_server(proc)
        stop_server(cache_srv)
        shutil.rmtree(root, ignore_errors=True)
    idle = [k for k, c in counts.items() if not c.get("ragged")]
    if idle:
        fail(f"KV phase: the ragged kernel never launched on {idle}")
    return counts


# -- Phi-3-mini at full depth ------------------------------------------------------
def phi3_serve_phase(torch, pa, smi: str) -> None:
    """Phi-3-mini at its published width, PHI3_SERVE_LAYERS of its 32
    layers (seeded random bf16 weights) written as an HF checkpoint in a
    temporary directory under build/ that the phase removes, served by
    the CLI under the default attention_impl auto (the gather path:
    head_dim 96; log build/chip_smoke_phi3_serve.log): three short
    requests and one PHI3_LONG_PROMPT_TOKENS-token request past the
    2047-token window, sent at once, each answers its max_tokens with
    finish reason length and no kernel launches; request seconds
    printed."""
    import shutil
    import tempfile

    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.models.debug_checkpoint import (
        write_hf_checkpoint,
    )

    t_phase = time.perf_counter()
    (REPO / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="phi3-", dir=REPO / "build"))
    ckdir = root / "phi-3-mini"
    proc = None
    hf = dict(PHI_3_MINI, num_hidden_layers=PHI3_SERVE_LAYERS)
    try:
        ckdir.mkdir()
        (ckdir / "config.json").write_text(json.dumps(hf))
        cfg = get_model_config(str(ckdir))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
        t0 = time.perf_counter()
        shards = write_hf_checkpoint(str(ckdir), hf, params,
                                     shard_bytes=5 * 10**9)
        size = sum(os.path.getsize(p) for p in shards)
        print(f"phi-3 phase: {cfg.num_layers} layers, head_dim "
              f"{cfg.head_dim}, window {cfg.sliding_window}: wrote "
              f"{len(shards)} shards, {size / 1e9:.2f} GB, in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
        del params
        release(torch)
        port = free_port()
        log_path = REPO / "build" / "chip_smoke_phi3_serve.log"
        t0 = time.perf_counter()
        proc = start_server(port, log_path, model=str(ckdir))
        boot = wait_healthy("phi-3 phase", proc, port, log_path, t0)
        want = (f"attention impl: xla (head_dim 96 not in "
                f"{pa.KERNEL_HEAD_DIMS})")
        if want not in log_path.read_text(errors="replace"):
            fail(f"phi-3 phase: the server log lacks '{want}':\n"
                 f"{log_tail(log_path)}")
        print(f"phi-3 phase: --model <dir> server healthy {boot:.1f}s "
              f"after start (the load included), its log: '{want}'",
              flush=True)
        st, body = http(port, "/debug/kernel_launches", method="DELETE")
        if st != 200:
            fail(f"phi-3 phase: launch counts not reset: {body}")
        prompts = [[(13 * i + 7 * j) % 31999 + 1 for j in range(n)]
                   for i, n in enumerate((24, 300, 900,
                                          PHI3_LONG_PROMPT_TOKENS))]

        def ask(ids):
            t1 = time.perf_counter()
            st, body = http(port, "/v1/completions", {
                "prompt": ids, "max_tokens": 16, "temperature": 0,
                "ignore_eos": True})
            r = json.loads(body)
            u = r.get("usage", {})
            if not (st == 200 and r["choices"][0]["finish_reason"] == "length"
                    and u.get("completion_tokens") == 16
                    and u.get("prompt_tokens") == len(ids)):
                fail(f"phi-3 phase: bad answer to a {len(ids)}-token "
                     f"prompt: {body[:400]}")
            return time.perf_counter() - t1

        t1 = time.perf_counter()
        with ThreadPoolExecutor(len(prompts)) as ex:
            secs = list(ex.map(ask, prompts))
        wall = time.perf_counter() - t1
        report = json.loads(http(port, "/debug/kernel_launches")[1])
        if any(report["launches"].values()):
            fail(f"phi-3 phase: the gather path launched kernels {report}")
        print(f"phi-3 phase: {len(prompts)} requests at once (prompts "
              f"{[len(p) for p in prompts]} tokens, 16 generated each) "
              f"answered in {wall:.2f}s; seconds each "
              f"{[round(x, 3) for x in secs]} (host clock); dispatches "
              f"{report['dispatches']}, no kernel launch, on {smi}",
              flush=True)
    finally:
        if proc is not None:
            stop_server(proc)
        shutil.rmtree(root, ignore_errors=True)
    release(torch)
    print(f"phi-3 phase: {time.perf_counter() - t_phase:.1f}s", flush=True)


# -- Gemma-7B serve phase -------------------------------------------------------
# the Gemma-7B server's requests: prompts of these lengths at once, the
# longest in six 512-token prefill chunks that ride mixed rounds beside
# the others' decode rows
GEMMA_PROMPT_TOKENS = (24, 300, 900, 3000)
GEMMA_MAX_TOKENS = 16
GEMMA_KV_BLOCKS = 256  # 8192 tokens at 448 KiB a token: 3.8 GB


def impl_logits(torch, runner, prompts) -> dict:
    """The served model's forwards on one runner, on the kernels and on
    the gather path: each prompt prefilled in 512-token chunks by each
    impl (the last chunk's last-row logits), then one decode step of all
    the prompts' lanes on the gather path's cache, on the ragged kernel
    and on the gather path. {impl: (prefill rows, decode rows)}, f32."""
    from production_stack_tpu_torch.ops import attention

    bs, chunk = runner.block_size, 512
    tables, nxt = [], 1
    for p in prompts:
        n = -(-(len(p) + 1) // bs)
        tables.append(list(range(nxt, nxt + n)))
        nxt += n
    fns = {"kernels": dict(runner._attn_fns),
           "gather": {"prefill": attention.paged_prefill_attention_gather,
                      "decode": attention.paged_decode_attention_gather}}
    args = ([11 * (i + 1) for i in range(len(prompts))],
            [len(p) for p in prompts], tables,
            [len(p) + 1 for p in prompts])

    def use(impl):
        runner._attn_fns = fns[impl]
        runner.ragged_kernel = impl == "kernels"

    # eager steps: a captured decode graph would replay the first impl
    runner.eager = True
    pf, dec = {}, {}
    try:
        for impl in ("kernels", "gather"):
            use(impl)
            rows = []
            for p, tb in zip(prompts, tables):
                for s0 in range(0, len(p), chunk):
                    ids = p[s0:s0 + chunk]
                    _, lg = runner.prefill(ids, s0, tb, s0 + len(ids))
                rows.append(lg.float().reshape(-1))
            pf[impl] = torch.stack(rows)
        for impl in ("gather", "kernels"):
            use(impl)
            dec[impl] = runner.decode(*args)[:len(prompts)].float()
    finally:
        use("kernels")
        runner.eager = False
    torch.cuda.synchronize()
    return {impl: (pf[impl], dec[impl]) for impl in pf}


def max_rel(torch, a, b) -> tuple[float, float]:
    """(max|a - b|, that over max|b|); fails on a non-finite value."""
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail("non-finite logits")
    diff = float((a - b).abs().max())
    return diff, diff / float(b.abs().max())


# the served Gemma-7B's logits in float32, kernels (their f32 CUDA-core
# path) against the gather path: summation order only, which moved a
# random-weight model's logits by ~3e-5 of their largest through all 28
# layers; a page, mask or tile fault moves them by far more
GEMMA_F32_LOGIT_REL_TOL = 1e-3


def gemma_serve_phase(torch, pa, gap_tol: float, smi: str) -> dict:
    """Gemma-7B at its published width, GEMMA_SERVE_LAYERS of its 28
    layers (seeded random bf16 weights) served on the kernels: written as
    an HF checkpoint in a temporary directory under build/ that the phase
    removes and served by the CLI under the default attention_impl auto
    (log build/chip_smoke_gemma_serve.log). GEMMA_PROMPT_TOKENS prompts
    at once, GEMMA_MAX_TOKENS tokens each: each answers with finish
    reason length, the log holds no 'attention impl: xla' warning, mixed
    rounds ran (tpu:ragged_rounds_total), launches one a layer a
    forward; then the same requests on the gather path (--attention-impl xla, log
    build/chip_smoke_gemma_xla_serve.log; no kernel launch), and the
    kernels' greedy streams held to its under the near-tie rule. The
    same prompts on one in-process runner of the same weights, on each
    impl (impl_logits): in float32 the kernels' prefill and decode
    logits within GEMMA_F32_LOGIT_REL_TOL of the gather path's, and in
    bf16 their largest difference is the streams' near-tie bound.
    Returns the kernels' launches."""
    import shutil
    import tempfile

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.model_runner import ModelRunner
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.models.debug_checkpoint import (
        write_hf_checkpoint,
    )

    t_phase = time.perf_counter()
    (REPO / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="gemma-", dir=REPO / "build"))
    ckdir = root / "gemma-7b"
    procs = []
    prompts = [[(13 * i + 7 * j) % 255999 + 1 for j in range(n)]
               for i, n in enumerate(GEMMA_PROMPT_TOKENS)]
    hf = dict(GEMMA_7B, num_hidden_layers=GEMMA_SERVE_LAYERS)
    try:
        ckdir.mkdir()
        (ckdir / "config.json").write_text(json.dumps(hf))
        cfg = get_model_config(str(ckdir))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
        size = sum(t.numel() * t.element_size()
                   for t in torch.utils._pytree.tree_leaves(params))
        t0 = time.perf_counter()
        shards = write_hf_checkpoint(str(ckdir), hf, params,
                                     shard_bytes=5 * 10**9)
        print(f"gemma phase: {cfg.num_layers} layers, head_dim "
              f"{cfg.head_dim}, {size / 1e9:.2f} GB: wrote {len(shards)} "
              f"shards in {time.perf_counter() - t0:.2f}s", flush=True)
        del params
        release(torch)

        def serve(impl: str):
            tag = "" if impl == "auto" else f"_{impl}"
            log_path = REPO / "build" / f"chip_smoke_gemma{tag}_serve.log"
            t0 = time.perf_counter()
            port = free_port()
            procs.append(start_server(
                port, log_path, model=str(ckdir),
                extra=("--num-kv-blocks", str(GEMMA_KV_BLOCKS),
                       "--attention-impl", impl)))
            boot_s = wait_healthy(f"gemma phase ({impl})", procs[-1], port,
                                  log_path, t0)
            if "attention impl: xla (" in log_path.read_text(
                    errors="replace"):
                fail(f"gemma phase ({impl}): the server warned of the "
                     "gather path")
            print(f"gemma phase: {impl} server healthy {boot_s:.1f}s after "
                  "start (the load included), no 'attention impl: xla' "
                  "warning", flush=True)
            st, body = http(port, "/debug/kernel_launches", method="DELETE")
            if st != 200:
                fail(f"gemma phase ({impl}): launch counts not reset: "
                     f"{body}")
            rounds0 = metric(port, "tpu:ragged_rounds_total")

            def ask(ids):
                t1 = time.perf_counter()
                st, body = http(port, "/v1/completions", {
                    "prompt": ids, "max_tokens": GEMMA_MAX_TOKENS,
                    "temperature": 0, "ignore_eos": True, "logprobs": 2,
                    "return_tokens_as_token_ids": True})
                r = json.loads(body)
                u = r.get("usage", {})
                if not (st == 200
                        and r["choices"][0]["finish_reason"] == "length"
                        and u.get("completion_tokens") == GEMMA_MAX_TOKENS
                        and u.get("prompt_tokens") == len(ids)):
                    fail(f"gemma phase ({impl}): bad answer to a "
                         f"{len(ids)}-token prompt: {body[:400]}")
                return (HttpStream(r["choices"][0]),
                        time.perf_counter() - t1)

            t1 = time.perf_counter()
            with ThreadPoolExecutor(len(prompts)) as ex:
                got = list(ex.map(ask, prompts))
            wall = time.perf_counter() - t1
            rounds = metric(port, "tpu:ragged_rounds_total") - rounds0
            report = json.loads(http(port, "/debug/kernel_launches")[1])
            what = f"gemma phase ({impl})"
            check_launches(what, report["launches"], report["dispatches"],
                           layers=GEMMA_SERVE_LAYERS,
                           impl="ragged" if impl == "auto" else "xla")
            if impl == "auto" and not rounds > 0:
                fail(f"{what}: no mixed round ran")
            print(f"{what}: {len(prompts)} requests at once (prompts "
                  f"{list(GEMMA_PROMPT_TOKENS)} tokens, {GEMMA_MAX_TOKENS} "
                  f"generated each) answered in {wall:.2f}s; seconds each "
                  f"{[round(x[1], 3) for x in got]} (host clock); "
                  f"{rounds:.0f} mixed rounds; dispatches "
                  f"{report['dispatches']} on {smi}", flush=True)
            stop_server(procs.pop())
            release(torch)
            return [x[0] for x in got], report["launches"]

        kern, launches = serve("auto")
        ref, _ = serve("xla")
        # the same forwards on one runner of the same weights, on each
        # impl, in bf16 (the served dtype) and in float32: f32 holds the
        # kernels to the gather path through every layer; bf16's
        # largest logit difference is the streams' near-tie bound (the
        # 3B's gap_tol, printed beside it, is another model's)
        logits = {}
        for dt in ("bfloat16", "float32"):
            runner = ModelRunner(EngineConfig(
                model=str(ckdir), tokenizer="byte", device="cuda",
                block_size=32, num_kv_blocks=GEMMA_KV_BLOCKS, seed=SEED,
                dtype=dt, cache_dtype=dt))
            logits[dt] = impl_logits(torch, runner, prompts)
            del runner
            release(torch)
        tol = 0.0
        for k, what in enumerate(("prefill", "decode step")):
            d32, r32 = max_rel(torch, logits["float32"]["kernels"][k],
                               logits["float32"]["gather"][k])
            d16, r16 = max_rel(torch, logits["bfloat16"]["kernels"][k],
                               logits["bfloat16"]["gather"][k])
            ref32 = logits["float32"]["gather"][k]
            far = {impl: max_rel(torch, logits["bfloat16"][impl][k],
                                 ref32)[1] for impl in ("kernels", "gather")}
            print(f"gemma phase: {what} logits of {len(prompts)} lanes, "
                  f"kernels vs gather path: float32 max|dlogit|="
                  f"{d32:.3e}, /max|logit|={r32:.3e} (tol "
                  f"{GEMMA_F32_LOGIT_REL_TOL}); bfloat16 {d16:.4f}, "
                  f"/max|logit|={r16:.3e}; bf16 from the f32 gather path: "
                  f"kernels {far['kernels']:.3e}, gather path "
                  f"{far['gather']:.3e} of max|logit|", flush=True)
            if not r32 <= GEMMA_F32_LOGIT_REL_TOL:
                fail(f"gemma phase: float32 {what} logits on the kernels "
                     f"differ from the gather path's by {r32:.3e}")
            tol = max(tol, d16)
        print(f"gemma phase: near-tie bound {tol:.4f} (the 3B decode "
              f"phase's: {gap_tol:.4f})", flush=True)
        n_same = near_tie_check("gemma phase kernels vs gather path", ref,
                                kern, tol)
        print(f"gemma phase: {n_same}/{len(prompts)} greedy streams on the "
              "kernels equal to the gather path's; streams "
              f"{[s.token_ids for s in kern]}", flush=True)
    finally:
        for proc in procs:
            stop_server(proc)
        shutil.rmtree(root, ignore_errors=True)
    release(torch)
    print(f"gemma phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return launches


# -- MoE phase --------------------------------------------------------------------
# Mixtral-8x7B's depth on the card: 4 of its 32 layers (46.7B parameters
# do not fit one 80 GB card; 4 layers are 6.1B, 12.2 GB in bf16)
MIXTRAL_LAYERS = 4


def oneshot_streams(torch, cfg, params, outs) -> tuple[list, float]:
    """Each output's stream as one forward of its whole sequence (prompt
    and generated tokens but the last) on the gather attention over a
    contiguous cache in the params' dtype, no paging and no chunks: the
    greedy token and the
    top-2 logprobs at each generated position, for near_tie_check; and
    the largest |logit| of those positions."""
    from types import SimpleNamespace

    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.ops.attention import (
        context_attention_prefill,
    )

    refs, top_logit = [], 0.0
    for o in outs:
        ids = list(o.prompt_token_ids) + list(o.token_ids[:-1])
        n, p = len(ids), len(o.prompt_token_ids)
        shape = (cfg.num_layers, cfg.num_kv_heads, n, cfg.head_dim)
        kc = torch.zeros(shape, dtype=params["embed"].dtype, device="cuda")
        vc = torch.zeros_like(kc)
        pos = torch.arange(n, device="cuda")

        def attn(q, l, k, v):
            return context_attention_prefill(
                q, k[l].transpose(0, 1), v[l].transpose(0, 1), pos, n,
                cfg.head_dim**-0.5, window=cfg.sliding_window)

        logits, _, _ = llama.forward(
            cfg, params, torch.tensor(ids, device="cuda"), pos, kc, vc, pos,
            attn, logits_rows=torch.arange(p - 1, n, device="cuda"))
        top_logit = max(top_logit, float(logits.abs().max()))
        top = torch.log_softmax(logits.float(), -1).topk(2, dim=-1)
        vals, idx = top.values.tolist(), top.indices.tolist()
        refs.append(SimpleNamespace(
            token_ids=[i[0] for i in idx],
            logprobs=[{"top_logprobs": [
                {"token_id": t, "logprob": v} for t, v in zip(ti, vi)]}
                for ti, vi in zip(idx, vals)]))
    return refs, top_logit


def routed_oneshot(torch, cfg, params, outs) -> tuple[list, float, list]:
    """oneshot_streams, and each sequence's top-k expert sets as its
    forwards route them: per sequence a (layers, rows, k) tensor of
    sorted expert indices."""
    from production_stack_tpu_torch.ops import moe

    seen = []
    gating = moe.top_k_gating

    def spy(x, gate_w, k):
        gates = gating(x, gate_w, k)
        seen.append(gates.topk(k, dim=-1).indices.sort(dim=-1).values)
        return gates

    moe.top_k_gating = spy
    try:
        refs, top_logit = oneshot_streams(torch, cfg, params, outs)
    finally:
        moe.top_k_gating = gating
    layers = cfg.num_layers
    routes = [torch.stack(seen[i:i + layers])
              for i in range(0, len(seen), layers)]
    return refs, top_logit, routes


def agreed_logprob_diff(refs, outs) -> float:
    """The largest |logprob| difference of the same token between two
    paths, over every generated position where both pick it (the
    one-shot forward is fed the engine's tokens, so each position sees
    one prefix on both paths): the two paths' measured rounding on these
    very sequences."""
    diff = 0.0
    for r, o in zip(refs, outs):
        for k, (a, b) in enumerate(zip(r.token_ids, o.token_ids)):
            if a == b:
                diff = max(diff, abs(r.logprobs[k]["top_logprobs"][0][
                    "logprob"] - o.logprobs[k]["logprob"]))
    return diff


def moe_phase(torch, pa, gap_tol: float, smi: str) -> dict:
    """Mixtral-8x7B at its published widths (mixtral-8x7b preset),
    depth cut to MIXTRAL_LAYERS: 2 layers' logits held to the CPU; a
    1-layer checkpoint with block_sparse_moe.* keys written through
    models/safetensors_io.py and read back byte for byte; the MoE
    block's device time per layer at batch 8 against its bytes bound;
    then an engine on the default path (ragged kernel, K=8) serves the
    mixed phase's scenario with the ragged kernel MIXTRAL_LAYERS times a
    forward, in bf16 (its agreement with one-shot bf16 forwards printed)
    and on the same weights in float32, whose greedy streams are held to
    one-shot float32 forwards under the near-tie rule. Returns the bf16
    engine's launches."""
    import dataclasses
    import shutil
    import tempfile

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models import llama, safetensors_io
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.models.debug_checkpoint import (
        hf_config_of,
        write_hf_checkpoint,
    )
    from production_stack_tpu_torch.models.weights import load_hf_weights
    from production_stack_tpu_torch.ops import moe

    t_phase = time.perf_counter()
    full = get_model_config("mixtral-8x7b")
    cut = dataclasses.replace(full, num_layers=MIXTRAL_LAYERS)
    print(f"moe phase: Mixtral-8x7B at its published widths (hidden "
          f"{full.hidden_size}, intermediate {full.intermediate_size}, "
          f"{full.num_experts} experts, top-{full.num_experts_per_tok}, "
          f"{full.num_heads}/{full.num_kv_heads} heads, head_dim "
          f"{full.head_dim}), depth cut to {MIXTRAL_LAYERS} of "
          f"{full.num_layers} layers: {cut.num_params() / 1e9:.2f}B "
          f"params, {cut.num_params() * 2 / 1e9:.1f} GB in bf16 (all "
          f"{full.num_layers} layers, {full.num_params() / 1e9:.1f}B "
          "params, do not fit one card)", flush=True)

    cfg2 = dataclasses.replace(full, num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg2, gen, torch.bfloat16, "cuda")
    card_vs_cpu(torch, pa, "moe phase Mixtral-8x7B x2 layers bf16", cfg2,
                params)
    del params
    release(torch)

    cfg1 = dataclasses.replace(full, num_layers=1)
    (REPO / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="mixtral-", dir=REPO / "build"))
    try:
        d = str(root / "mixtral-1l")
        params = llama.init_params(cfg1, gen, torch.bfloat16, "cuda")
        t0 = time.perf_counter()
        shards = write_hf_checkpoint(d, hf_config_of(cfg1), params,
                                     shard_bytes=5 * 10**9)
        t1 = time.perf_counter()
        loaded = load_hf_weights(get_model_config(d), d, torch.bfloat16,
                                 "cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        names = set()
        for path in shards:
            names |= set(safetensors_io.read_header(path)[0])
        moe_keys = [k for k in names if ".block_sparse_moe." in k]
        if (len(moe_keys) != 1 + 3 * full.num_experts
                or any(".mlp." in k for k in names)
                or not tree_equal(torch, loaded, params)):
            fail(f"moe phase: the 1-layer Mixtral checkpoint ({len(moe_keys)}"
                 " block_sparse_moe tensors) did not load back byte for "
                 "byte")
        size = sum(os.path.getsize(p) for p in shards)
        print(f"moe phase: a 1-layer Mixtral checkpoint, {len(moe_keys)} "
              f"block_sparse_moe.* tensors, {size / 1e9:.2f} GB: wrote "
              f"{t1 - t0:.2f}s, loaded onto the card {t2 - t1:.2f}s, byte "
              "for byte", flush=True)
        del params, loaded
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release(torch)

    class CutConfig(EngineConfig):
        """The mixtral-8x7b preset at MIXTRAL_LAYERS layers."""

        def model_config(self):
            return cut

    sp = SamplingParams(max_tokens=32, temperature=0, ignore_eos=True,
                        logprobs=2)
    eng = LLMEngine(CutConfig(
        model="mixtral-8x7b", tokenizer="byte", device="cuda",
        block_size=32, num_kv_blocks=512, max_num_seqs=8, seed=SEED,
        num_scheduler_steps=8))
    if not eng.runner.ragged_kernel:
        fail("moe phase: the default engine is not on the ragged kernel")

    lp = {k: v[0] for k, v in eng.runner.params["layers"].items()}
    x = (torch.randn((8, full.hidden_size), generator=gen, device="cuda")
         * 0.5).bfloat16()

    def block():
        return moe.moe_block(x, lp["moe_gate"], lp["w_gate"], lp["w_up"],
                             lp["w_down"], full.num_experts_per_tok)

    for _ in range(3):
        block()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(20):
        block()
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) / 20
    nbytes = sum(lp[k].numel() * lp[k].element_size()
                 for k in ("moe_gate", "w_gate", "w_up", "w_down"))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"moe phase: MoE block (dense, all {full.num_experts} experts) "
          f"at batch 8, one layer: {ms * 1e3:.1f} us device (CUDA events, "
          f"mean of 20 back-to-back calls, {nbytes / 1e9:.2f} GB of "
          f"weights each, past the L2) against its bytes bound "
          f"{bound * 1e3:.1f} us (router and expert weights read once at "
          f"3.35 TB/s): {bound / ms:.1%} of the bound, on {smi}",
          flush=True)

    outs, got, runs, n_mixed, wall = staggered_mix(torch, pa, eng, "moe", 0,
                                                   sp)
    what = "moe phase engine"
    print(f"{what}: mixed scenario in {wall:.3f}s (host clock), {n_mixed} "
          f"lane-typed rounds; dispatches {runs}", flush=True)
    if n_mixed < 1:
        fail(f"{what}: no lane-typed round ran")
    check_launches(what, got, runs, layers=MIXTRAL_LAYERS)
    check_pool(what, eng.runner, smi)
    # the same weights in float32, for the engine below and to see how
    # often bf16 rounding alone moves a token to another expert pair:
    # one-shot forwards of these sequences in each dtype
    params32 = {k: ({n: w.float() for n, w in v.items()}
                    if isinstance(v, dict) else v.float())
                for k, v in eng.runner.params.items()}
    refs, _, r16 = routed_oneshot(torch, cut, eng.runner.params, outs)
    _, _, r32 = routed_oneshot(torch, cut, params32, outs)
    moved = sum(int((a != b).any(dim=-1).sum()) for a, b in zip(r16, r32))
    total = sum(a.shape[0] * a.shape[1] for a in r16)
    n16 = sum(r.token_ids == o.token_ids for r, o in zip(refs, outs))
    print(f"{what}: {n16}/{len(outs)} greedy token sequences equal to "
          f"one-shot bf16 forwards; the same token's |dlogprob| up to "
          f"{agreed_logprob_diff(refs, outs):.4f} over the positions where "
          f"they agree. Top-2 routing of these sequences: {moved} of "
          f"{total} (layer, token) expert pairs differ between the bf16 "
          "and float32 one-shot forwards, so bf16 rounding alone moves "
          "tokens to other experts; the streams are held in float32 "
          "below", flush=True)
    del eng, refs, r16, r32
    release(torch)
    eng = LLMEngine(CutConfig(
        model="mixtral-8x7b", tokenizer="byte", device="cuda",
        block_size=32, num_kv_blocks=512, max_num_seqs=8, seed=SEED,
        num_scheduler_steps=8, dtype="float32", cache_dtype="float32"),
        params=params32)
    outs32, got32, runs32, _, wall32 = staggered_mix(torch, pa, eng,
                                                     "moe32", 0, sp)
    what32 = f"{what} (float32)"
    print(f"{what32}: mixed scenario in {wall32:.3f}s (host clock); "
          f"dispatches {runs32}", flush=True)
    check_launches(what32, got32, runs32, layers=MIXTRAL_LAYERS)
    check_pool(what32, eng.runner, smi)
    refs, _ = oneshot_streams(torch, cut, params32, outs32)
    d32 = agreed_logprob_diff(refs, outs32)
    n_same = near_tie_check(f"{what32} (vs one-shot forwards)", refs,
                            outs32, gap_tol)
    print(f"{what32}: {n_same}/{len(outs32)} greedy token sequences equal "
          f"to one-shot float32 forwards of the same weights, the same "
          f"token's |dlogprob| up to {d32:.2e} where they agree, on {smi}",
          flush=True)
    del eng, params32
    release(torch)
    print(f"moe phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return {k: got[k] for k in ("decode", "prefill", "ragged")}


# -- tensor-parallel phase -----------------------------------------------------
# tp=2 on the one card: rank 0 in this process, rank 1 spawned, both on
# cuda:0 over gloo (NCCL refuses two ranks on one device). The ranks sum
# their f32 partials of wo and w_down (gloo through the host) where the
# tp=1 forward sums them inside one GEMM: the same kind of summation
# order change as the decode phase's two kernels, so its bound is used
# for one-shot logits, tp=2 against tp=1 (max|dlogit| / max|logit|)
TP_LOGIT_REL_TOL = DECODE_LOGIT_REL_TOL
TP_KV_BLOCKS = 512  # 3.5 MiB a block on a rank (nkv 4 of 8), 7 on tp=1
TP_ONESHOT_TOKENS = 512


def tp_kernel_shapes(torch) -> None:
    """The three kernels through their *_tp wrappers at one rank's local
    shape of Llama-3.2-3B at tp=2 (nq=12 over nkv=4, d=128, bs=32), on
    the kernel phase's decode lanes and 512-row chunk: bf16 and f32
    against the plain versions at the kernel phase's tolerances, then
    time (mean of 20 after an L2 flush) beside the profiler's device time
    and the host's enqueue time per call, the plain version's (mean of
    3), the bound and the library call at the same local shape, as the
    kernel phase defines them: for the prefill chunk one SDPA
    (enable_gqa) over the chunk's context read once under the causal
    mask, for the decode lanes one SDPA of each lane's row over its
    context padded to the table width."""
    import numpy as np
    import torch.nn.functional as F

    from production_stack_tpu_torch.engine.model_runner import (
        decode_segments,
    )
    from production_stack_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    nq, nkv, d, bs, L = 12, 4, 128, 32, 2
    num_blocks = 2560
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    kc = torch.randn((L, nkv, num_blocks * bs, d), generator=gen,
                     device=dev, dtype=torch.bfloat16)
    vc = torch.randn_like(kc)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    tp_kw = dict(num_heads=2 * nq, num_kv_heads=2 * nkv, tp_size=2,
                 block_size=bs, scale=d**-0.5)
    plain_kw = dict(block_size=bs, scale=d**-0.5)
    dec_ctx = [1, 31, 32, 33, 500, 1000, 1531, 2047]
    P = -(-max(dec_ctx) // bs)
    perm = np.random.default_rng(SEED).permutation(num_blocks)
    tables = torch.from_numpy(
        perm[:len(dec_ctx) * P].reshape(len(dec_ctx), P).astype(np.int32)
    ).to(dev)
    ctx = torch.tensor(dec_ctx, dtype=torch.int32, device=dev)
    _, blk, meta = decode_segments(np.asarray(dec_ctx, np.int32))
    blk, meta = (torch.from_numpy(x).to(dev) for x in (blk, meta))
    qd = torch.randn((len(dec_ctx), nq, d), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    t, qs = 512, 1024
    qp = torch.randn((t, nq, d), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    pf_table = tables[-1]
    dec_kv = sum(dec_ctx)
    g = nq // nkv

    def padded_decode_sdpa():
        """Each lane's row (b, nq, 1, d) over its context padded to the
        table width, K/V repeated over the g query heads, under a
        visibility mask (the kernel phase's decode yardstick)."""
        C = tables.shape[1] * bs
        sl = (tables.long()[:, :, None] * bs
              + torch.arange(bs, device=dev)).reshape(len(dec_ctx), C)
        k = kc[1][:, sl].permute(1, 0, 2, 3).repeat_interleave(g, 1)
        v = vc[1][:, sl].permute(1, 0, 2, 3).repeat_interleave(g, 1)
        mask = torch.arange(C, device=dev)[None, :] < ctx[:, None]
        return (qd[:, :, None].contiguous(), k.contiguous(),
                v.contiguous(), mask[:, None, None].contiguous(), False)

    def fair_prefill_sdpa():
        """The chunk's rows (1, nq, t, d) over its context read once,
        (1, nkv, qs + t, d), GQA through enable_gqa, causal mask (the
        kernel phase's prefill yardstick)."""
        pos = torch.arange(qs + t, device=dev)
        sl = pf_table.long()[pos // bs] * bs + pos % bs
        mask = pos[None, :] <= (qs + torch.arange(t, device=dev))[:, None]
        return (qp.transpose(0, 1)[None].contiguous(),
                kc[1][:, sl][None].contiguous(),
                vc[1][:, sl][None].contiguous(),
                mask[None, None].contiguous(), True)

    cases = {
        "ragged_paged_attention_tp (decode lanes)": (
            pa.ragged_paged_attention_tp, pa.ragged_paged_attention_plain,
            qd, (tables, blk, meta), len(dec_ctx), dec_kv,
            sum(c for c in dec_ctx), ("ragged_tile_kernel",),
            padded_decode_sdpa),
        "paged_prefill_attention_tp": (
            pa.paged_prefill_attention_tp, pa.paged_prefill_attention_plain,
            qp, (pf_table, qs), t, qs + t, sum(qs + i + 1 for i in range(t)),
            ("prefill_kernel",), fair_prefill_sdpa),
        "paged_decode_attention_tp": (
            pa.paged_decode_attention_tp, pa.paged_decode_attention_plain,
            qd, (tables, ctx), len(dec_ctx), dec_kv, dec_kv,
            ("decode_split_kernel", "decode_merge_kernel"),
            padded_decode_sdpa),
    }
    for name, (fn, plain, q, extra, rows, kv_tok, visible, cuda_names,
               lib_args) in cases.items():
        for dt, tol in ((torch.bfloat16, BF16_REL_TOL),
                        (torch.float32, F32_REL_TOL)):
            qq, kk, vv = (x.to(dt) for x in (q, kc, vc))
            out = fn(qq, kk, vv, 1, *extra, **tp_kw).float()
            ref = plain(qq, kk, vv, 1, *extra, **plain_kw).float()
            torch.cuda.synchronize()
            err = (out - ref).abs()
            worst = float((err / (tol * ref.abs().amax(-1, keepdim=True))
                           .clamp_min(1e-30)).max())
            print(f"tp kernels: {name} {str(dt)[6:]}: max_abs_err="
                  f"{float(err.max()):.3e} worst err/tol={worst:.3f}",
                  flush=True)
            if not worst <= 1.0:
                fail(f"tp kernels: {name} off its plain version by "
                     f"{worst:.3f}x the tolerance")
            del kk, vv
        ms = time_cuda(torch, lambda: fn(q, kc, vc, 1, *extra, **tp_kw),
                       20, flush)
        split = device_breakdown(
            torch, lambda: fn(q, kc, vc, 1, *extra, **tp_kw), flush,
            cuda_names)
        plain_ms = time_cuda(
            torch, lambda: plain(q, kc, vc, 1, *extra, **plain_kw), 3,
            flush)
        q4, k4, v4, m4, gqa = lib_args()
        lib_ms = time_cuda(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4, scale=d**-0.5,
            **({"enable_gqa": True} if gqa else {})), 20, flush)
        del q4, k4, v4, m4
        t_bytes = (2 * kv_tok * nkv * d * 2 + 2 * rows * nq * d * 2
                   ) / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * visible * nq * d / BF16_FLOPS * 1e3
        bms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                               "operations")
        print(f"tp kernels: {name} at the tp=2 local shape (nq {nq}, nkv "
              f"{nkv}, d {d}, bs {bs}): kernel_ms={ms:.4f} (profiler, per "
              f"call: {split}) plain_ms={plain_ms:.3f} bound_ms={bms:.4f} "
              f"({by}), bound/kernel={bms / ms:.3f} library_ms="
              f"{lib_ms:.4f}", flush=True)
    del kc, vc, flush
    release(torch)


def tp_forward_check(torch, what: str, ref, eng, ids: list[int],
                     layers: int) -> float:
    """One-shot forward of `ids` (one prefill chunk over free blocks of an
    idle engine) on the tp=1 engine `ref` and the tp=2 engine `eng`:
    last-row logits, max|dlogit| / max|logit| held to TP_LOGIT_REL_TOL,
    and each rank's launches of the tp=2 forward (counted from 0 after
    the tp=1 one, which rank 0's process counts too) held to one prefill
    launch a layer."""
    n_blk = -(-len(ids) // ref.config.block_size)
    table = list(range(1, 1 + n_blk))
    out = [ref.runner.prefill(ids, 0, table, len(ids))[1].float()]
    torch.cuda.synchronize()
    eng.runner.reset_counts()
    runs0 = [dict(r["dispatch_counts"]) for r in eng.runner.reports()]
    out.append(eng.runner.prefill(ids, 0, table, len(ids))[1].float())
    torch.cuda.synchronize()
    top = float(out[0].abs().max())
    rel = float((out[1] - out[0]).abs().max()) / top
    print(f"{what}: one-shot {len(ids)}-token forward, last-row logits "
          f"tp=2 vs tp=1 on the card max|d|/max|logit|={rel:.3e} "
          f"(tol {TP_LOGIT_REL_TOL})", flush=True)
    if not (torch.isfinite(out[1]).all() and rel <= TP_LOGIT_REL_TOL):
        fail(f"{what}: tp=2 logits differ from tp=1 by {rel:.3e}")
    tp_rank_check(f"{what} one-shot forward", eng.runner.reports(), layers,
                  runs0)
    return rel


def tp_rank_check(what: str, reports: list[dict], layers: int,
                  runs0: list[dict] | None = None) -> list[dict]:
    """Every rank launched the ragged kernel once a layer per
    ragged-kernel forward and the prefill kernel once a layer per
    single-sequence prefill (counted from its last reset, dispatches
    from `runs0`), on the card only: no tensor of the params or the KV
    cache off it, no collective on a host tensor. Returns each rank's
    launch counts."""
    out = []
    for i, rep in enumerate(reports):
        runs = dict(rep["dispatch_counts"])
        if runs0 is not None:
            runs = {k: v - runs0[i][k] for k, v in runs.items()}
        check_launches(f"{what} rank {rep['rank']}", rep["launches"], runs,
                       layers=layers)
        if rep["tensor_devices"] != ["cuda:0"] or rep["host_collectives"]:
            fail(f"{what} rank {rep['rank']}: tensors on "
                 f"{rep['tensor_devices']}, {rep['host_collectives']} "
                 "collectives on host tensors")
        out.append(rep["launches"])
    return out


def tp_phase(torch, pa, gap_tol: float, smi: str) -> dict:
    """Llama-3.2-3B (full width, TP_LAYERS layers, bf16, seeded random
    weights, byte tokenizer) at tp=2 on the one card (start_tp_ranks
    with devices [cuda:0, cuda:0] and gloo; rank 1 spawned) beside a
    tp=1 engine on the same seed, both K=8 (under tp: split rounds, the
    fused K-step decode on the ragged kernel, no staging): a one-shot
    512-token forward's logits held to tp=1's; the mixed phase's
    scenario (four greedy 32-token requests, a 1500-token prompt at step
    2) on both, streams held to tp=1's under the near-tie rule, and
    every rank's launches held to TP_LAYERS a forward; wall ms a token
    at batch 8 in turns (gloo through the host on one shared card: not a
    TP speed). Then the Qwen2-7B 2-layer checkpoint (qkv bias split,
    untied lm_head vocab-sharded, g = 7 on a rank) at tp=2: logits held
    to tp=1's. Returns rank 0's and rank 1's launches over the
    scenario."""
    import shutil
    import tempfile

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.models.debug_checkpoint import (
        write_hf_checkpoint,
    )
    from production_stack_tpu_torch.parallel.launch import start_tp_ranks

    def tp_engine(cfg):
        t0 = time.perf_counter()
        group = start_tp_ranks(cfg, devices=["cuda:0", "cuda:0"],
                               backend="gloo")
        eng = LLMEngine(cfg, tp_group=group)
        return eng, time.perf_counter() - t0

    def stop(eng, what):
        """Shut the rank set down; a follower that did not exit cleanly
        fails the run."""
        followers = list(eng.tp_group.followers)
        eng.shutdown()
        codes = [p.exitcode for p in followers]
        if codes != [0] * len(followers):
            fail(f"{what}: followers exited with {codes}")

    base = dict(model=cut_3b(), tokenizer="byte", device="cuda",
                block_size=32, num_kv_blocks=TP_KV_BLOCKS, max_num_seqs=8,
                seed=SEED, num_scheduler_steps=8)
    ref = LLMEngine(EngineConfig(**base))
    eng, boot = tp_engine(EngineConfig(**base, tensor_parallel_size=2))
    try:
        print(f"tp phase: tp=2 rank set (gloo, both ranks on cuda:0) and "
              f"its engine up in {boot:.1f}s; ragged rounds "
              f"{eng._ragged_dispatch}, staging off", flush=True)
        ids = [(5 * j + 3) % 250 + 1 for j in range(TP_ONESHOT_TOKENS)]
        tp_forward_check(torch, f"tp phase {base['model']}", ref, eng,
                         ids, TP_LAYERS)
        sp = SamplingParams(max_tokens=32, temperature=0, ignore_eos=True,
                            logprobs=2)
        outs, walls = {}, {}
        for tag, e in (("tp1", ref), ("tp2", eng)):
            if tag == "tp2":
                e.runner.reset_counts()
                runs0 = [dict(r["dispatch_counts"])
                         for r in e.runner.reports()]
            outs[tag], _, _, _, walls[tag] = staggered_mix(
                torch, pa, e, f"tp-{tag}", 0, sp)
        counts = tp_rank_check("tp phase mixed scenario",
                               eng.runner.reports(), TP_LAYERS, runs0)
        if min(c["ragged"] for c in counts) < TP_LAYERS:
            fail(f"tp phase: a rank never launched the ragged kernel: "
                 f"{counts}")
        n_same = near_tie_check("tp phase tp=2 vs tp=1", outs["tp1"],
                                outs["tp2"], gap_tol)
        print(f"tp phase: {n_same}/5 greedy streams (4 x 32 tokens and the "
              f"{LONG_PROMPT_TOKENS}-token prompt's) equal to tp=1's; the "
              f"scenario's wall {walls['tp2']:.2f}s at tp=2 against "
              f"{walls['tp1']:.2f}s at tp=1; launches a rank {counts}",
              flush=True)
        ms = {"tp1": [], "tp2": []}
        for turn, tag in enumerate(("tp2", "tp1", "tp1", "tp2")):
            e = eng if tag == "tp2" else ref
            ms[tag].append(decode_batch8(torch, e, f"tp-{tag}-b8", turn))
        print(f"tp phase: wall ms a generated token at batch 8 (K=8, host "
              f"clock; tp=2 is gloo through the host with both ranks on "
              f"one shared card, not a tensor-parallel speed): tp=2 "
              f"{', '.join(f'{x:.3f}' for x in ms['tp2'])}; tp=1 "
              f"{', '.join(f'{x:.3f}' for x in ms['tp1'])} ({smi})",
              flush=True)
    finally:
        stop(eng, f"tp phase {base['model']}")
        del ref
        release(torch)

    (REPO / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="tp-qwen2-", dir=REPO / "build"))
    try:
        name = "Qwen2-7B"
        hf = dict(FAMILY_CONFIGS[name], num_hidden_layers=FAMILY_LAYERS)
        (root / "config.json").write_text(json.dumps(hf))
        cfg = get_model_config(str(root))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
        for b in ("bq", "bk", "bv"):
            params["layers"][b] = (torch.randn(
                params["layers"][b].shape, generator=gen,
                device="cuda") * 0.5).bfloat16()
        write_hf_checkpoint(str(root), hf, params)
        del params
        release(torch)
        qbase = dict(model=str(root), tokenizer="byte", device="cuda",
                     block_size=32, num_kv_blocks=64, max_num_seqs=4,
                     seed=SEED)
        qref = LLMEngine(EngineConfig(**qbase))
        qeng, boot = tp_engine(EngineConfig(**qbase, tensor_parallel_size=2))
        try:
            print(f"tp phase {name}: {FAMILY_LAYERS} layers at tp=2 "
                  f"({cfg.num_heads // 2} q heads over "
                  f"{cfg.num_kv_heads // 2} kv heads a rank, qkv bias, "
                  f"untied lm_head of {cfg.vocab_size} split in two), each "
                  f"rank loading its shard from the checkpoint: up in "
                  f"{boot:.1f}s", flush=True)
            tp_forward_check(torch, f"tp phase {name}", qref, qeng,
                             [(7 * j + 1) % 250 + 1 for j in range(300)],
                             FAMILY_LAYERS)
        finally:
            stop(qeng, f"tp phase {name}")
            del qref
            release(torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"rank0": counts[0], "rank1": counts[1]}


# -- long-context phase ----------------------------------------------------------
# the ring against its oracle (plain_attention, a float32 result), per
# (row, head): |out - ref| <= TOL * max|ref| over d. Both compute float32
# products of the same inputs. In bf16 the ring rounds its float32
# result once: half a step (2^-8 of the row's largest value), one step
# where a value sits just under a power of two; 2^-6 is the kernel
# phase's bound. In f32 they differ by the summation order only (the
# kernel phase's f32 bound)
LC_BF16_REL_TOL = BF16_REL_TOL
LC_F32_REL_TOL = F32_REL_TOL
LC_RING_ROWS = 8192
LC_SP = 2
LC_PREFILL_TOKENS = 4096
# the 28-layer prefiller's K/V against chunked prefill on the prefill
# kernel, per (layer, row, kv head) relative to the row's max|ref| over
# d: bf16 roundings that part in attention (f32 ring vs the kernel's
# bf16 P) and travel through the layers; the last-row logits' bound is
# the decode phase's 3e-2 of max|logit|
LC_KV_REL_TOL = 2.0**-4
LC_THRESHOLD = 4096
LC_CHUNK = 2048
# 8 ring chunks of 2048 tokens (the last part-filled), S_pad 16384
LC_PROMPT_TOKENS = 16000
# the four decoders run alone for LC_LONG_STEP steps, then beside the
# long prompt, and outlast its lane
LC_DECODE_TOKENS = 64
LC_LONG_STEP = 12
LC_CLI_PROMPT_TOKENS = 5000


def per_row_check(torch, what: str, out, ref, tol: float) -> float:
    """Held per (row, head): |out - ref| <= tol * max|ref| over the last
    dim; returns the max abs error."""
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    bound = tol * ref.float().abs().amax(-1, keepdim=True)
    worst = float((err / bound.clamp_min(1e-30)).max())
    max_err = float(err.max())
    print(f"{what}: max_abs_err={max_err:.3e} worst err/tol={worst:.3f} "
          f"(tol {tol:.3g} x max|ref| per row, head)", flush=True)
    if not (torch.isfinite(out).all() and worst <= 1.0):
        fail(f"{what}: off its reference by {worst:.3f}x the tolerance")
    return max_err


def plain_attention(torch, q, k, v, window=None):
    """Causal softmax attention of (1, n, h, d) q over (1, n, hk, d) k / v
    in float32, built apart from the port's grouping helpers: K and V
    repeated to the q heads, an explicit causal (and HF window: keys j
    with i - window < j <= i) mask, eight heads at a time."""
    n, nq, d = q.shape[1], q.shape[2], q.shape[3]
    g = nq // k.shape[2]
    qpos = torch.arange(n, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    kr = k[0].float().repeat_interleave(g, dim=1).transpose(0, 1)
    vr = v[0].float().repeat_interleave(g, dim=1).transpose(0, 1)
    qh = q[0].float().transpose(0, 1)
    out = torch.empty((nq, n, d), dtype=torch.float32, device=q.device)
    for h0 in range(0, nq, 8):
        h1 = min(h0 + 8, nq)
        s = (qh[h0:h1] @ kr[h0:h1].transpose(1, 2)) * d ** -0.5
        s.masked_fill_(~keep, float("-inf"))
        out[h0:h1] = torch.softmax(s, dim=-1) @ vr[h0:h1]
        del s
    return out.transpose(0, 1)[None]


def ring_oracle_checks(torch, smi: str) -> None:
    """(a) ring_attention over sp=2 and sp=4 ranks on the card against
    plain_attention (float32, K/V repeated to the q heads: not the
    port's grouping) on the card: the 3B's heads (24 q over 8 kv, d 128)
    causal, and Mistral-7B's (32 over 8) with its 4096-token window
    (ring_attention_blocks, as the prefiller calls it), 8192 rows, bf16
    and f32 on the same inputs; ms of each (CUDA events, mean of 3,
    float32 products with TF32 off)."""
    from production_stack_tpu_torch.parallel import ring_attention as ra

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    n, d = LC_RING_ROWS, 128
    for name, nq, nkv, window, sps in (("Llama-3.2-3B", 24, 8, None, (2, 4)),
                                       ("Mistral-7B", 32, 8, 4096, (2, 4))):
        q = torch.randn((1, n, nq, d), generator=gen, device=dev)
        k = torch.randn((1, n, nkv, d), generator=gen, device=dev)
        v = torch.randn((1, n, nkv, d), generator=gen, device=dev)
        for dt, tol in ((torch.bfloat16, LC_BF16_REL_TOL),
                        (torch.float32, LC_F32_REL_TOL)):
            qq, kk, vv = (x.to(dt) for x in (q, k, v))
            ref = plain_attention(torch, qq, kk, vv, window=window)
            ref_ms = time_cuda(torch, lambda: plain_attention(
                torch, qq, kk, vv, window=window), 3, flush)
            for sp in sps:
                lk = n // sp
                kb = [kk[:, j * lk:(j + 1) * lk] for j in range(sp)]
                vb = [vv[:, j * lk:(j + 1) * lk] for j in range(sp)]

                def ring():
                    return ra.ring_attention_blocks(qq, kb, vb,
                                                    window=window)

                what = (f"long-context phase ring {name} (nq {nq}, nkv "
                        f"{nkv}{f', window {window}' if window else ''}) "
                        f"sp={sp} {str(dt)[6:]} {n} rows")
                if window is None:
                    # the whole-array entry, which shards k and v itself
                    per_row_check(torch, what, ra.ring_attention(
                        qq, kk, vv, [dev] * sp), ref, tol)
                else:
                    per_row_check(torch, what, ring(), ref, tol)
                ms = time_cuda(torch, ring, 3, flush)
                print(f"{what}: ring_ms={ms:.3f} oracle_ms={ref_ms:.3f} "
                      f"(float32 products, TF32 off; one card holds "
                      f"every rank) on {smi}", flush=True)
            del ref, qq, kk, vv
            release(torch)
    del flush
    release(torch)


def lc_prefill_check(torch, pa, params, cfg, smi: str) -> None:
    """(b) LongContextPrefiller.prefill of a LC_PREFILL_TOKENS-token
    prompt at sp=2 on the 28-layer 3B against the port's chunked prefill
    of the same prompt (512-row chunks, the prefill kernel, a contiguous
    paged cache): last-row logits within DECODE_LOGIT_REL_TOL of
    max|logit|, every K/V row within LC_KV_REL_TOL; the prefiller uses
    the caller's params (no copy) and launches no kernel."""
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.parallel.long_context import (
        LongContextPrefiller,
    )

    n, bs, chunk = LC_PREFILL_TOKENS, 32, 512
    ids = [(j * 7919) % cfg.vocab_size for j in range(n)]
    pre = LongContextPrefiller(cfg, params, ["cuda"] * LC_SP,
                               cache_dtype=torch.bfloat16)
    if pre.params is not params or any(d.type != "cuda"
                                       for d in pre.devices):
        fail("long-context phase: the prefiller copied the params or left "
             "the card")
    pa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kc, vc, _ = pre.prefill(ids)
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    if any(pa.launch_counts().values()):
        fail(f"long-context phase: the ring launched paged-attention "
             f"kernels {pa.launch_counts()}")
    rows = kc.shards[0].shape[2]
    pages = n // bs
    shape = (cfg.num_layers, cfg.num_kv_heads, (pages + 1) * bs,
             cfg.head_dim)
    kp = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    vp = torch.zeros_like(kp)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")
    tok = torch.tensor(ids, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s0 in range(0, n, chunk):
        pos = torch.arange(s0, s0 + chunk, device="cuda")

        def attn(q, l, k, v, s0=s0):
            return pa.paged_prefill_attention(
                q, k, v, l, table, s0, block_size=bs,
                scale=cfg.head_dim**-0.5)

        want, _, _ = llama.forward(
            cfg, params, tok[s0:s0 + chunk], pos, kp, vp, pos + bs, attn,
            logits_rows=torch.tensor([chunk - 1], device="cuda"))
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    got = pa.launch_counts()
    if got["prefill"] != cfg.num_layers * (n // chunk):
        fail(f"long-context phase: chunked control launches {got}")
    want = want[0].float()
    top = float(want.abs().max())
    rel = float((logits.float() - want).abs().max()) / top
    print(f"long-context phase prefiller: {n}-token prompt, "
          f"{cfg.num_layers} layers, "
          f"sp={LC_SP} ({rows} cache rows a rank) in {ring_s:.3f}s against "
          f"chunked prefill on the prefill kernel ({n // chunk} chunks of "
          f"{chunk}) in {chunked_s:.3f}s (host clock, synchronized); "
          f"last-row logits max|d|/max|logit|={rel:.3e} (tol "
          f"{DECODE_LOGIT_REL_TOL}) on {smi}", flush=True)
    if not (torch.isfinite(logits).all() and rel <= DECODE_LOGIT_REL_TOL):
        fail(f"long-context phase: prefiller logits off by {rel:.3e}")
    for name, ring_c, paged in (("K", kc, kp), ("V", vc, vp)):
        per_row_check(torch, f"long-context phase prefiller {name} rows "
                      f"({cfg.num_layers} layers x {n} rows x "
                      f"{cfg.num_kv_heads} kv heads) vs chunked",
                      ring_c.gather()[:, :, :n], paged[:, :, bs:bs + n],
                      LC_KV_REL_TOL)
    del kc, vc, kp, vp, logits
    release(torch)
    # one ring chunk of the lane's shape (LC_CHUNK rows at the top of its
    # padded sequence) under the profiler: its kernels, device time and
    # the host's enqueue share
    s_pad = pre.seq_pad(LC_PROMPT_TOKENS, LC_CHUNK)
    kc, vc = pre.begin_cache(s_pad)
    toks = pre.stage_tokens(ids[:LC_CHUNK], LC_CHUNK)
    prof = profile_step(torch, lambda: pre.prefill_chunk(
        kc, vc, toks, s_pad - LC_CHUNK, LC_CHUNK - 1))
    print(f"long-context phase: one {LC_CHUNK}-row ring chunk over "
          f"S_pad {s_pad} (sp={LC_SP}, {cfg.num_layers} layers) under "
          f"torch.profiler: {prof} on {smi}", flush=True)
    del kc, vc, pre
    release(torch)


def lane_logits(mgr) -> dict:
    """Spy on a lane manager's advance: the first-token logits (on the
    host, float32) of each job that finished landing, by request id."""
    got = {}
    advance = mgr.advance

    def spy():
        done, failed, progressed = advance()
        for rec in done:
            got[rec["rid"]] = rec["logits"].float().clone()
        return done, failed, progressed

    mgr.advance = spy
    return got


def lc_scenario(torch, pa, eng, tag: str, sp,
                n_long: int = LC_PROMPT_TOKENS) -> dict:
    """Four greedy LC_DECODE_TOKENS-token requests, then the
    n_long-token prompt at step LC_LONG_STEP while they decode.
    Returns the streams (d0..d3, long), the TTFT of the long prompt, the
    step walls in which the decoders got a token (in steps that
    dispatched a ring chunk, in other steps with the long prompt's
    prefill in flight, and with none), the decode rounds run while a
    ring was in flight, the ring chunks' dispatch ms, the launches and
    dispatches over the run and over the decode after the long prompt's
    first token, and the memory peak."""
    prompts = [[(11 * i + 5 * j) % 250 + 1 for j in range(n)]
               for i, n in enumerate((17, 40, 64, 90))]
    long_prompt = [(3 * j + 1) % 250 + 1 for j in range(n_long)]
    mgr = eng.long_prefill
    chunk_ms: list[float] = []
    if mgr is not None:
        dispatch = mgr._dispatch_next_chunk

        def timed(rec):
            t = time.perf_counter()
            dispatch(rec)
            chunk_ms.append((time.perf_counter() - t) * 1e3)

        mgr._dispatch_next_chunk = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    runs0 = dict(eng.runner.dispatch_counts)
    for i, p in enumerate(prompts):
        eng.add_request(f"{tag}d{i}", prompt_token_ids=p, sampling_params=sp)
    finals, step, ttft, t_long = {}, 0, None, None
    itl = {"chunk": [], "in flight": [], "none": []}
    ring_rounds, after = 0, None
    while eng.has_unfinished():
        if step == LC_LONG_STEP:
            eng.add_request(f"{tag}long", prompt_token_ids=long_prompt,
                            sampling_params=sp)
            t_long = time.perf_counter()
        long_seq = eng._seqs.get(f"{tag}long")
        busy = long_seq is not None and not (
            long_seq.prefill_done and not long_seq.long_prefill_active)
        ring = mgr is not None and mgr.active
        rounds0, chunks0 = eng._decode_rounds_total, len(chunk_ms)
        ts = time.perf_counter()
        outs = eng.step()
        dt = time.perf_counter() - ts
        if ring and eng._decode_rounds_total > rounds0:
            ring_rounds += 1
        if any(o.new_token_ids and not o.request_id.endswith("long")
               for o in outs):
            itl["chunk" if len(chunk_ms) > chunks0 else
                "in flight" if busy else "none"].append(dt * 1e3)
        for o in outs:
            if (o.request_id == f"{tag}long" and o.token_ids
                    and ttft is None):
                ttft = time.perf_counter() - t_long
                torch.cuda.synchronize()
                launches0 = pa.launch_counts()
                after = (launches0, dict(eng.runner.dispatch_counts))
            if o.finished:
                finals[o.request_id] = o
        step += 1
    torch.cuda.synchronize()
    if mgr is not None:
        del mgr._dispatch_next_chunk
    end = pa.launch_counts()
    runs = {k: v - runs0[k] for k, v in eng.runner.dispatch_counts.items()}
    tail = ({k: end[k] - after[0][k] for k in end},
            {k: v - after[1][k] for k, v in eng.runner.dispatch_counts.items()})
    return {"outs": [finals[f"{tag}{r}"] for r in ("d0", "d1", "d2", "d3",
                                                    "long")],
            "ttft": ttft, "itl": itl, "ring_rounds": ring_rounds,
            "chunk_ms": chunk_ms, "launches": end, "runs": runs,
            "tail": tail, "steps": step,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def lc_engine_check(torch, pa, gap_tol: float, smi: str) -> dict:
    """(c) the lane in an engine at full width: the 3B (TP_LAYERS layers,
    bf16, seeded params) with long_prefill_threshold LC_THRESHOLD,
    context_parallel_size LC_SP and long_prefill_chunk LC_CHUNK beside
    the same engine without the lane (chunked prefill on the kernels),
    on the same seed, each serving lc_scenario. The lane: one request,
    8 chunks, 0 fallbacks, ring / d2h / land seconds > 0, ring devices on
    the card, no 'DISABLED' or 'failed' warning, decode rounds while the
    ring was in flight, TP_LAYERS ragged launches a forward over the run
    and over the decode after landing (the ring launches none); the
    streams held to the control's under the near-tie rule. Returns the
    lane engine's launches and the long prompt's first-token logits from
    the ring (the tp=1 reference of the rank-set serving phase (g))."""
    import logging

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    warned: list = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda r: warned.append(r.getMessage())
    logging.getLogger(
        "production_stack_tpu_torch.engine.llm_engine").addHandler(handler)
    base = dict(model=cut_3b(), tokenizer="byte", device="cuda",
                block_size=32, num_kv_blocks=640, max_num_seqs=8, seed=SEED)
    sp = SamplingParams(max_tokens=LC_DECODE_TOKENS, temperature=0,
                        ignore_eos=True, logprobs=2)
    res = {}
    try:
        for tag, lane in (("lane", True), ("chunked", False)):
            over = (dict(long_prefill_threshold=LC_THRESHOLD,
                         context_parallel_size=LC_SP,
                         long_prefill_chunk=LC_CHUNK) if lane else {})
            eng = LLMEngine(EngineConfig(**base, **over))
            try:
                if lane:
                    mgr = eng.long_prefill
                    if mgr is None or any(d.type != "cuda"
                                          for d in mgr.prefiller.devices):
                        fail(f"long-context phase: the lane is not live on "
                             f"the card: {warned}")
                    if mgr.prefiller.params["embed"] is not (
                            eng.runner.params["embed"]):
                        fail("long-context phase: the ring copied the "
                             "runner's params")
                    first = lane_logits(mgr)
                res[tag] = lc_scenario(torch, pa, eng, f"lc-{tag}-", sp)
                res[tag]["stats"] = eng.stats()
            finally:
                eng.shutdown()
                del eng
                release(torch)
    finally:
        logging.getLogger(
            "production_stack_tpu_torch.engine.llm_engine").removeHandler(
            handler)
    bad = [w for w in warned if "DISABLED" in w or "failed" in w]
    if bad:
        fail(f"long-context phase: {bad}")
    shared = [w for w in warned if "share the serving card" in w]
    if len(shared) != 1:
        fail(f"long-context phase: the lane engine on one card gave "
             f"{len(shared)} shared-card warnings, not 1")
    print(f"long-context phase lane engine warned: {shared[0]}", flush=True)
    lane, ctrl = res["lane"], res["chunked"]
    st = lane["stats"]
    n_chunks = -(-LC_PROMPT_TOKENS // LC_CHUNK)
    counters = (st.long_prefill_requests_total, st.long_prefill_chunks_total,
                st.long_prefill_fallbacks_total)
    phases = (st.long_prefill_ring_seconds_total,
              st.long_prefill_d2h_seconds_total,
              st.long_prefill_land_seconds_total)
    print(f"long-context phase lane: requests, chunks, fallbacks {counters}; "
          f"ring / d2h / land / overflow seconds "
          f"{[round(x, 4) for x in phases]} / "
          f"{st.long_prefill_overflow_seconds_total:.4f}; {lane['steps']} "
          f"steps; decode rounds while a ring was in flight "
          f"{lane['ring_rounds']}", flush=True)
    if counters != (1, n_chunks, 0) or not all(x > 0 for x in phases):
        fail(f"long-context phase: lane counters {counters}, phase "
             f"seconds {phases}")
    if lane["ring_rounds"] < 3:
        fail(f"long-context phase: only {lane['ring_rounds']} decode "
             "rounds ran while the ring was in flight")
    if ctrl["stats"].long_prefill_requests_total:
        fail("long-context phase: the control engine took the lane")
    for tag, r in res.items():
        check_launches(f"long-context phase {tag} engine", r["launches"],
                       r["runs"], layers=TP_LAYERS)
        check_launches(f"long-context phase {tag} engine, decode after the "
                       f"long prompt's first token", *r["tail"],
                       layers=TP_LAYERS)
    if lane["tail"][1]["decode"] + lane["tail"][1]["decode_iterations"] < 1:
        fail("long-context phase: no decode forward after landing")
    n_same = near_tie_check("long-context phase lane vs chunked",
                            ctrl["outs"], lane["outs"], gap_tol)

    def ms(xs):
        return (f"median {sorted(xs)[len(xs) // 2]:.2f} ms, max "
                f"{max(xs):.2f} over {len(xs)}" if xs else "none")

    cms = lane["chunk_ms"]
    print(f"long-context phase: {n_same}/5 greedy streams (4 x "
          f"{LC_DECODE_TOKENS} tokens and the {LC_PROMPT_TOKENS}-token "
          f"prompt's, {TP_LAYERS} layers) of the lane equal to the chunked "
          f"control's; TTFT of "
          f"the long prompt: ring {lane['ttft']:.3f}s, chunked "
          f"{ctrl['ttft']:.3f}s (host clock); step-thread host ms a ring "
          f"chunk's dispatch {[round(x, 1) for x in cms]}; ITL of the four "
          f"decoders (step wall): lane engine in a step that dispatched a "
          f"ring chunk {ms(lane['itl']['chunk'])}, in other steps with the "
          f"ring's d2h or landing in flight {ms(lane['itl']['in flight'])}, "
          f"without a ring {ms(lane['itl']['none'])}; chunked engine with "
          f"the prompt's chunks in flight {ms(ctrl['itl']['in flight'])}, "
          f"without {ms(ctrl['itl']['none'])}; memory peak "
          f"{lane['peak_gb']:.2f} GB "
          f"(lane engine) / {ctrl['peak_gb']:.2f} GB (chunked); a ring on "
          f"one card shares that card: not sp speeds; on {smi}", flush=True)
    return lane["launches"], first["lc-lane-long"]


def lc_cli_check(torch, smi: str) -> None:
    """(d) the CLI with --long-prefill-threshold LC_THRESHOLD
    --context-parallel-size LC_SP (log build/chip_smoke_lc_serve.log):
    /v1/models carries sp_size, one LC_CLI_PROMPT_TOKENS-token greedy
    completion is answered, /metrics shows one long-prefill request and
    no fallback, and the server's launches are 28 a forward."""
    port = free_port()
    log_path = REPO / "build" / "chip_smoke_lc_serve.log"
    t0 = time.perf_counter()
    proc = start_server(port, log_path, extra=(
        "--long-prefill-threshold", str(LC_THRESHOLD),
        "--context-parallel-size", str(LC_SP)))
    try:
        boot = wait_healthy("long-context phase CLI", proc, port, log_path,
                            t0)
        card = json.loads(http(port, "/v1/models")[1])["data"][0]
        if card.get("sp_size") != LC_SP:
            fail(f"long-context phase CLI: /v1/models card {card}:\n"
                 f"{log_tail(log_path)}")
        http(port, "/debug/kernel_launches", method="DELETE")
        ids = [(5 * j + 2) % 250 + 1 for j in range(LC_CLI_PROMPT_TOKENS)]
        t1 = time.perf_counter()
        st, body = http(port, "/v1/completions", {
            "prompt": ids, "max_tokens": 8, "temperature": 0,
            "ignore_eos": True})
        secs = time.perf_counter() - t1
        r = json.loads(body)
        u = r.get("usage", {})
        if not (st == 200 and u.get("prompt_tokens") == len(ids)
                and u.get("completion_tokens") == 8):
            fail(f"long-context phase CLI: bad answer {body[:400]}")
        report = json.loads(http(port, "/debug/kernel_launches")[1])
        check_launches("long-context phase CLI", report["launches"],
                       report["dispatches"])
        reqs = metric(port, "tpu:long_prefill_requests_total")
        falls = metric(port, "tpu:long_prefill_fallbacks_total")
        if reqs != 1 or falls != 0:
            fail(f"long-context phase CLI: /metrics long-prefill requests "
                 f"{reqs}, fallbacks {falls}")
        print(f"long-context phase CLI: healthy {boot:.1f}s after start, "
              f"/v1/models sp_size {card['sp_size']}, a "
              f"{len(ids)}-token completion in {secs:.3f}s, "
              f"tpu:long_prefill_requests_total {reqs:g}, fallbacks "
              f"{falls:g} on {smi}", flush=True)
    finally:
        stop_server(proc)


def long_context_phase(torch, pa, gap_tol: float, smi: str) -> dict:
    """The long-context path (parallel/ring_attention.py,
    parallel/long_context.py, engine/long_prefill.py) at full width:
    (a) the ring against its oracle, (b) the prefiller against chunked
    prefill, (c) the lane in an engine against the chunked control,
    (d) the lane through the CLI. Returns the lane engine's launches and
    its long prompt's first-token logits."""
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config

    t_phase = time.perf_counter()
    ring_oracle_checks(torch, smi)
    cfg = get_model_config("llama-3.2-3b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
    lc_prefill_check(torch, pa, params, cfg, smi)
    del params
    release(torch)
    counts, first = lc_engine_check(torch, pa, gap_tol, smi)
    lc_cli_check(torch, smi)
    print(f"long-context phase: {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return counts, first


# -- pipeline-parallel phase -------------------------------------------------------
PP_KV_BLOCKS = 512
PP_ONESHOT_TOKENS = 512
PP_PREFILL_TOKENS = 4096
# the pp forward against pp=1, both on the gather path: the same bf16
# math in the same order on one card (a stage's rows reach the next stage
# bit for bit), so the decode phase's bound holds with room
PP_LOGIT_REL_TOL = DECODE_LOGIT_REL_TOL
# (rank set name, pp, tp): every rank on the one card over gloo
PP_LAYOUTS = (("pp2", 2, 1), ("pp2 x tp2", 2, 2))


def pp_rank_check(what: str, reports: list[dict], pp: int, tp: int,
                  layers: int) -> None:
    """Every rank of a pp x tp set: stage r // tp, tp index r % tp,
    layers / pp layers held, no kernel launch (pp serves on the gather
    path, as the JAX engine serves it on XLA), its tensors on cuda:0, no
    collective on a host tensor, the same dispatches as rank 0 and the
    step descriptors it read from the store equal to those rank 0
    published."""
    steps = reports[0]["store_steps"]
    for rep in reports:
        r = rep["rank"]
        print(f"{what} rank {r}: stage {rep['stage']}, tp index "
              f"{rep['tp_rank']}, {rep['layers']} layers, store steps "
              f"{rep['store_steps']}, broadcasts {rep['broadcasts']}, "
              f"all-reduces {rep['all_reduces']}, launches "
              f"{rep['launches']}", flush=True)
        if ((rep["stage"], rep["tp_rank"]) != divmod(r, tp)
                or rep["layers"] != layers // pp
                or any(rep["launches"].values())
                or rep["tensor_devices"] != ["cuda:0"]
                or rep["host_collectives"] or rep["store_steps"] != steps
                or rep["dispatch_counts"] != reports[0]["dispatch_counts"]):
            fail(f"{what} rank {r}: report {rep}")


def pp_prefiller_check(torch, smi: str) -> None:
    """parallel/pipeline.PipelinedPrefiller on the 3B (full width,
    TP_LAYERS layers), 2 stages both on the card: a PP_PREFILL_TOKENS-token prompt's logits (every
    row) within PP_LOGIT_REL_TOL of max|logit| and every K/V row within
    LC_KV_REL_TOL of a one-shot forward's (contiguous cache rows, the
    plain chunk attention); no kernel launch."""
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.ops import paged_attention as pa
    from production_stack_tpu_torch.ops.attention import (
        context_attention_prefill,
    )
    from production_stack_tpu_torch.parallel.pipeline import (
        PipelinedPrefiller,
        make_pp_stages,
    )

    cfg = get_model_config(cut_3b())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
    n = PP_PREFILL_TOKENS
    ids = [(j * 7919 + 3) % cfg.vocab_size for j in range(n)]
    pre = PipelinedPrefiller(cfg, params,
                             make_pp_stages(2, ["cuda:0", "cuda:0"]))
    pa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kcs, vcs, T = pre.prefill(ids)
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    if any(pa.launch_counts().values()) or T != n:
        fail(f"pp phase prefiller: T {T}, launches {pa.launch_counts()}")
    kc = torch.zeros((cfg.num_layers, cfg.num_kv_heads, n, cfg.head_dim),
                     dtype=torch.bfloat16, device="cuda")
    vc = torch.zeros_like(kc)
    pos = torch.arange(n, device="cuda")

    def attn(q, l, k, v):
        return context_attention_prefill(
            q, k[l].transpose(0, 1), v[l].transpose(0, 1), pos, n,
            cfg.head_dim**-0.5)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, _, _ = llama.forward(cfg, params, torch.tensor(ids, device="cuda"),
                               pos, kc, vc, pos, attn, logits_rows=pos)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    rel = float((logits - want).abs().max()) / float(want.abs().max())
    print(f"pp phase prefiller: {n}-token prompt through 2 stages x "
          f"{cfg.num_layers // 2} layers ({pre.num_microbatches} "
          f"microbatches, both stages on cuda:0) in {pipe_s:.3f}s, the "
          f"one-shot forward in {one_s:.3f}s (host clock, synchronized); "
          f"logits of all {n} rows max|d|/max|logit|={rel:.3e} (tol "
          f"{PP_LOGIT_REL_TOL}) on {smi}", flush=True)
    if not (torch.isfinite(logits).all() and rel <= PP_LOGIT_REL_TOL):
        fail(f"pp phase prefiller: logits off by {rel:.3e}")
    del logits, want
    for name, got, ref in (("K", kcs, kc), ("V", vcs, vc)):
        per_row_check(torch, f"pp phase prefiller {name} rows "
                      f"({cfg.num_layers} layers x {n} rows x "
                      f"{cfg.num_kv_heads} kv heads) vs one-shot",
                      torch.cat(got)[:, :, :n], ref, LC_KV_REL_TOL)
    del kcs, vcs, kc, vc, pre, params
    release(torch)


def pp_phase(torch, pa, gap_tol: float, smi: str) -> None:
    """Llama-3.2-3B (full width, TP_LAYERS layers, bf16, seeded random
    weights, byte tokenizer) served at pp=2 (two ranks on cuda:0 over
    gloo, TP_LAYERS / 2 layers each) and at pp=2 x tp=2 (four ranks on
    cuda:0), each rank set
    started once, against one pp=1 engine on the gather path
    (attention_impl xla) on the same seed, all K=8 (under pp: split
    rounds, the fused K-step decode, no staging): a one-shot
    PP_ONESHOT_TOKENS-token forward's logits held to pp=1's; the mixed
    phase's scenario (four greedy 32-token requests, a 1500-token prompt
    at step 2), streams held to pp=1's under the near-tie rule and every
    rank's report checked (pp_rank_check); wall ms a token at batch 8 in
    turns (ranks share one card over gloo: not a PP speed). Then the
    pipelined prefiller (pp_prefiller_check)."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.parallel.launch import start_tp_ranks

    t_phase = time.perf_counter()
    base = dict(model=cut_3b(), tokenizer="byte", device="cuda",
                block_size=32, num_kv_blocks=PP_KV_BLOCKS, max_num_seqs=8,
                seed=SEED, num_scheduler_steps=8)
    sp = SamplingParams(max_tokens=32, temperature=0, ignore_eos=True,
                        logprobs=2)
    ids = [(5 * j + 3) % 250 + 1 for j in range(PP_ONESHOT_TOKENS)]
    table = list(range(1, 1 + -(-len(ids) // 32)))
    ref = LLMEngine(EngineConfig(**base, attention_impl="xla"))
    try:
        want = ref.runner.prefill(ids, 0, table, len(ids))[1].float()
        ref_outs, _, _, _, ref_wall = staggered_mix(torch, pa, ref, "pp-ref",
                                                    0, sp)
        for tag, pp, tp in PP_LAYOUTS:
            t0 = time.perf_counter()
            cfg = EngineConfig(**base, pipeline_parallel_size=pp,
                               tensor_parallel_size=tp)
            group = start_tp_ranks(cfg, devices=["cuda:0"] * (pp * tp),
                                   backend="gloo")
            eng = LLMEngine(cfg, tp_group=group)
            try:
                print(f"pp phase {tag}: {pp * tp} ranks (gloo, all on "
                      f"cuda:0) and the engine up in "
                      f"{time.perf_counter() - t0:.1f}s; attention impl "
                      f"{eng.runner.attention_impl}, ragged rounds "
                      f"{eng._ragged_dispatch}, staging off", flush=True)
                got = eng.runner.prefill(ids, 0, table, len(ids))[1].float()
                torch.cuda.synchronize()
                rel = float((got - want).abs().max()) / float(
                    want.abs().max())
                print(f"pp phase {tag}: one-shot {len(ids)}-token forward, "
                      f"last-row logits vs pp=1 max|d|/max|logit|="
                      f"{rel:.3e} (tol {PP_LOGIT_REL_TOL}) on {smi}",
                      flush=True)
                if not (torch.isfinite(got).all()
                        and rel <= PP_LOGIT_REL_TOL):
                    fail(f"pp phase {tag}: logits off pp=1's by {rel:.3e}")
                eng.runner.reset_counts()
                outs, _, runs, _, wall = staggered_mix(
                    torch, pa, eng, f"pp-{tag}", 0, sp)
                pp_rank_check(f"pp phase {tag}", eng.runner.reports(), pp,
                              tp, TP_LAYERS)
                n_same = near_tie_check(f"pp phase {tag} vs pp=1",
                                        ref_outs, outs, gap_tol)
                print(f"pp phase {tag}: {n_same}/5 greedy streams (4 x 32 "
                      f"tokens and the {LONG_PROMPT_TOKENS}-token prompt's) "
                      f"equal to pp=1's; dispatches {runs}; the scenario's "
                      f"wall {wall:.2f}s against {ref_wall:.2f}s at pp=1 on "
                      f"{smi}", flush=True)
                ms = {"pp": [], "pp1": []}
                for turn, who in enumerate(("pp", "pp1", "pp1", "pp")):
                    ms[who].append(decode_batch8(
                        torch, eng if who == "pp" else ref,
                        f"pp-{tag}-{who}-b8", turn))
                print(f"pp phase {tag}: wall ms a generated token at batch "
                      f"8 (K=8, host clock; ranks share one card over "
                      f"gloo: not a PP speed): {tag} "
                      f"{', '.join(f'{x:.3f}' for x in ms['pp'])}; pp=1 "
                      f"{', '.join(f'{x:.3f}' for x in ms['pp1'])} on "
                      f"{smi}", flush=True)
            finally:
                followers = list(eng.tp_group.followers)
                eng.shutdown()
                codes = [p.exitcode for p in followers]
                if codes != [0] * len(followers):
                    fail(f"pp phase {tag}: followers exited with {codes}")
    finally:
        del ref
        release(torch)
    pp_prefiller_check(torch, smi)
    print(f"pp phase: {time.perf_counter() - t_phase:.1f}s", flush=True)


# -- multi-host phase ----------------------------------------------------------------
MH_PROMPT = [(13 * j + 5) % 250 + 1 for j in range(200)]
MH_TOKENS = 32
# the stream engine b serves when the stack phase SIGTERMs it
STACK_SIGTERM_TOKENS = 160
# process 1 must exit within this many seconds of process 0's SIGTERM
MH_EXIT_S = 30.0


def multihost_phase(torch, gap_tol: float, smi: str, model: str) -> dict:
    """Two processes of the port's CLI joined into one job on loopback
    (--multihost --num-processes 2 --process-id {0,1}
    --coordinator-address 127.0.0.1:<port> --tensor-parallel-size 2),
    serving `model` (main hands it the 3B at full width and TP_LAYERS
    layers as a checkpoint), each process one rank on cuda:0 over gloo
    (logs build/chip_smoke_mh{0,1}_serve.log): process 0 serves HTTP,
    process 1 follows. A greedy completion of MH_PROMPT equals an
    in-process tp=1 engine's on the checkpoint under
    the near-tie rule (a single-process tp=2 reference would add a rank
    set's boot); rank 0 launches the ragged kernel TP_LAYERS times a
    forward
    (/debug/kernel_launches); after SIGTERM to process 0, which drains
    and shuts its engine down (the followers get the shutdown step),
    both processes exit 0 within MH_EXIT_S, process 1 having logged the
    shutdown. Returns rank 0's launches."""
    import types

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    t_phase = time.perf_counter()
    eng = LLMEngine(EngineConfig(
        model=model, tokenizer="byte", device="cuda",
        block_size=32, num_kv_blocks=64, max_num_seqs=8, seed=SEED))
    [ref] = eng.generate([MH_PROMPT], SamplingParams(
        max_tokens=MH_TOKENS, temperature=0, ignore_eos=True, logprobs=2))
    eng.shutdown()
    del eng
    release(torch)
    port, coord = free_port(), free_port()
    logs = [REPO / "build" / f"chip_smoke_mh{i}_serve.log" for i in (0, 1)]
    procs = []
    try:
        for i in (0, 1):
            procs.append(start_server(
                port if i == 0 else free_port(), logs[i], model=model,
                extra=(
                    "--multihost", "--num-processes", "2", "--process-id",
                    str(i), "--coordinator-address", f"127.0.0.1:{coord}",
                    "--tensor-parallel-size", "2")))
        boot = wait_healthy("multi-host phase", procs[0], port, logs[0],
                            t_phase)
        if procs[1].poll() is not None:
            fail(f"multi-host phase: process 1 exited with "
                 f"{procs[1].returncode}:\n{log_tail(logs[1])}")
        http(port, "/debug/kernel_launches", method="DELETE")
        t1 = time.perf_counter()
        st, body = http(port, "/v1/completions", {
            "prompt": MH_PROMPT, "max_tokens": MH_TOKENS, "temperature": 0,
            "ignore_eos": True, "logprobs": 2,
            "return_tokens_as_token_ids": True})
        secs = time.perf_counter() - t1
        r = json.loads(body)
        if st != 200 or r["usage"]["completion_tokens"] != MH_TOKENS:
            fail(f"multi-host phase: bad answer {body[:400]}")
        toks = [int(t.split(":")[1])
                for t in r["choices"][0]["logprobs"]["tokens"]]
        report = json.loads(http(port, "/debug/kernel_launches")[1])
        check_launches("multi-host phase rank 0", report["launches"],
                       report["dispatches"], layers=TP_LAYERS)
        n_same = near_tie_check("multi-host phase vs single-process tp=1",
                                [ref], [types.SimpleNamespace(
                                    token_ids=toks)], gap_tol)
        print(f"multi-host phase: two processes (one rank each, gloo on "
              f"cuda:0) healthy {boot:.1f}s after start; a "
              f"{len(MH_PROMPT)}-token prompt's {MH_TOKENS}-token greedy "
              f"completion in {secs:.3f}s, {n_same}/1 equal to a "
              f"single-process tp=1 engine's; rank 0 dispatches "
              f"{report['dispatches']} on {smi}", flush=True)
        procs[0].send_signal(signal.SIGTERM)
        t2 = time.perf_counter()
        try:
            codes = [p.wait(MH_EXIT_S) for p in procs]
        except subprocess.TimeoutExpired:
            fail(f"multi-host phase: a process still running "
                 f"{MH_EXIT_S:g}s after process 0's SIGTERM:\n"
                 + "\n".join(log_tail(lg) for lg in logs))
        waited = time.perf_counter() - t2
        told = "shutdown received" in logs[1].read_text(errors="replace")
        print(f"multi-host phase: processes exited with {codes} "
              f"{waited:.2f}s after SIGTERM to process 0 (bound "
              f"{MH_EXIT_S:g}s), process 1 on the shutdown step: {told}; "
              f"phase {time.perf_counter() - t_phase:.1f}s on {smi}",
              flush=True)
        if codes != [0, 0] or not told:
            fail(f"multi-host phase: after SIGTERM to process 0 the job "
                 f"did not stop cleanly (exit codes {codes}, shutdown "
                 f"step seen by process 1: {told}):\n"
                 + "\n".join(log_tail(lg) for lg in logs))
        return report["launches"]
    finally:
        for p in procs:
            stop_server(p)


# -- rank-set features phase ----------------------------------------------------
# the 3B rank set of this phase: tp=2 on the one card (both ranks on
# cuda:0 over gloo, as in the tp and pp phases: no time here is a
# tensor-parallel speed), LoRA on and the CPU tier under a 128-block pool:
# room for the adapter requests' blocks, the 47 of the KV prompt and 46
# to import into, which four prompts of churn then evict from the card
# (the CPU tier holds 320 blocks: all of them)
RS_KV_BLOCKS = 128
RS_LORA_RANK = 8
RS_LORA_TOKENS = 32
# the adapter lanes' one-shot prefill: last-row logits tp=2 vs tp=1 within
# the tp phase's bf16 bound, and each adapter lane at tp=2 farther than
# that bound from tp=1's base lane (a delta dropped on every rank shows
# there, one dropped or miscut on one rank in the first)
RS_LORA_ONESHOT_TOKENS = 200
# tests/test_moe.py's expert-parallel check at Mixtral-8x7B's widths,
# float32 (bf16 rounding alone moves tokens to other expert pairs, moe
# phase), on a 256-token one-shot prefill with every MoE block's input
# and router logits recorded in both runs (_GateSpy). Only the order of
# float32 sums differs at tp=2 (the wo all-reduce, the two ranks'
# expert partials, the kernels' head split), so every block's input
# agrees to RS_MOE_INPUT_REL_TOL of its max up to the first block whose
# top-2 routing parts, and that block may part only at tokens whose
# tp=1 top-2 margin is within the layer's router-logit difference (a
# near tie the sum order decides); one such flip moves every later row.
# On an H100 the sound run reads at most 2.7e-6 on the inputs, one flip
# at a 1.37e-6 margin in layer 1 and 5.323e-3 on the last-row logits;
# the same prefill in bfloat16 against float32 reads 7.6e-3 on layer 0's
# input and 3.28e-2 on the logits, and must stay above both bounds
RS_MOE_INPUT_REL_TOL = 1e-4
RS_MOE_LOGIT_REL_TOL = 1e-2
RS_MOE_ONESHOT_TOKENS = 256
RS_MOE_PROMPTS = [[(11 * j + 3 * i) % 250 + 1 for j in range(40 + 24 * i)]
                  for i in range(3)]


class _TransferHost:
    """The port's KVTransferServer for an in-process engine (a stand-in
    for AsyncLLMEngine: the engine and its lock) on a loop in a thread."""

    def __init__(self, engine):
        import asyncio
        import threading

        from production_stack_tpu_torch.kv import transfer

        self.engine, self._lock = engine, threading.Lock()
        self._ready = threading.Event()

        async def serve():
            srv = transfer.KVTransferServer(self)
            await srv.start("127.0.0.1", 0)
            self.port = srv.port
            self._loop = asyncio.get_running_loop()
            self._stop = asyncio.Event()
            self._ready.set()
            await self._stop.wait()
            await srv.stop()

        self._thread = threading.Thread(target=asyncio.run, args=(serve(),),
                                        daemon=True)
        self._thread.start()
        if not self._ready.wait(30):
            fail("rank-set phase: the KV transfer server did not start")

    def close(self):
        self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(timeout=15)


class _GateSpy:
    """Records every MoE block's input and router logits computed in this
    process (ops/moe.top_k_gating) inside `record`: a tp=1 engine's, or
    rank 0's of a rank set, whose routing every rank shares (the same x
    and the replicated router)."""

    def __init__(self):
        from production_stack_tpu_torch.ops import moe
        from production_stack_tpu_torch.ops.layers import matmul_f32

        self._moe, self._orig, self._rows = moe, moe.top_k_gating, None

        def spy(x, gate_w, k):
            if self._rows is not None:
                self._rows.append((x.float().cpu(),
                                   matmul_f32(x, gate_w).float().cpu()))
            return self._orig(x, gate_w, k)

        moe.top_k_gating = spy

    def record(self, fn):
        """fn()'s result and the (input, router logits) of each block it
        ran, in layer order."""
        self._rows = []
        try:
            return fn(), self._rows
        finally:
            self._rows = None

    def close(self):
        self._moe.top_k_gating = self._orig


def moe_parting(torch, want: list, got: list, k: int) -> list[dict]:
    """Per MoE block of two one-shot runs: max|dx| / max|x| of its input,
    max|d| of its router logits, the rows whose top-k expert sets part
    and the reference's largest top-k margin (k-th minus (k+1)-th logit)
    among them."""
    out = []
    for (xa, ga), (xb, gb) in zip(want, got):
        sa = torch.topk(ga, k, -1).indices.sort(-1).values
        sb = torch.topk(gb, k, -1).indices.sort(-1).values
        flips = (sa != sb).any(-1).nonzero().flatten().tolist()
        top = ga.sort(-1, descending=True).values
        margin = top[:, k - 1] - top[:, k]
        out.append({
            "dx": float((xa - xb).abs().max()) / float(xa.abs().max()),
            "dg": float((ga - gb).abs().max()),
            "flips": flips,
            "margin": max((float(margin[r]) for r in flips), default=0.0),
        })
    return out


def drive_lora(eng, reqs, sp) -> list:
    """Greedy requests [(prompt ids, adapter or None)] at once; their
    outputs in order."""
    rid = f"rs{time.monotonic_ns()}"
    for i, (ids, lora) in enumerate(reqs):
        eng.add_request(f"{rid}-{i}", prompt_token_ids=ids, lora_name=lora,
                        sampling_params=sp)
    done = {}
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished:
                done[o.request_id] = o
    return [done[f"{rid}-{i}"] for i in range(len(reqs))]


def rank_set_phase(torch, pa, gap_tol: float, smi: str) -> dict:
    """LoRA, the KV tier and PD on a Llama-3.2-3B tp=2 rank set (full
    width, TP_LAYERS layers, bf16, seeded random weights; both ranks on
    cuda:0 over gloo) beside a tp=1 engine of the same config; then Mixtral-8x7B at its
    widths, MIXTRAL_LAYERS layers, float32, with its experts split E/2 a
    rank. (a) two random rank-8 PEFT adapters: every rank's adapter
    buffers byte-equal to its cut of tp=1's, each lane's one-shot
    last-row logits held to tp=1's (and each adapter lane's away from
    the base's), base and adapter greedy streams held to tp=1's under
    the near-tie rule, an unload answered as tp=1 answers it; (b) the
    KV phase's 46-block export and import at tp=2 (rank 0 assembles
    the wire from each rank's slice; every rank's slice, read through a
    report step, byte-equal to its cut of the wire), then evict and
    restore through the CPU tier: the restored stream held to the cold
    one, 0 fallbacks; (c) PD: the tp=2 engine serves a tp=1 decode
    engine's pull; (d) the MoE set's one-shot prefill held to tp=1's
    block by block (RS_MOE_INPUT_REL_TOL, the near-tie routing rule) and
    on its logits, beside a bfloat16 control that must read above both
    bounds, and its greedy streams, each rank holding its experts and
    launching the ragged kernel MIXTRAL_LAYERS times a forward. Returns
    the launches of each rank set's driven run."""
    import dataclasses
    import shutil
    import tempfile

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.lora import write_peft_adapter
    from production_stack_tpu_torch.engine.multihost_engine import (
        tensor_digest,
    )
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models import config as mconfig
    from production_stack_tpu_torch.parallel import sharding
    from production_stack_tpu_torch.parallel.launch import start_tp_ranks

    t_phase = time.perf_counter()

    def tp_engine(cfg):
        t0 = time.perf_counter()
        group = start_tp_ranks(cfg, devices=["cuda:0", "cuda:0"],
                               backend="gloo")
        return LLMEngine(cfg, tp_group=group), time.perf_counter() - t0

    def stop(eng, what):
        followers = list(eng.tp_group.followers)
        eng.shutdown()
        codes = [p.exitcode for p in followers]
        if codes != [0] * len(followers):
            fail(f"{what}: followers exited with {codes}")

    cfg3 = mconfig.get_model_config(cut_3b())
    bs = 32
    layers, nkv, d = cfg3.num_layers, cfg3.num_kv_heads, cfg3.head_dim
    block_bytes = 2 * layers * nkv * bs * d * 2  # bf16 wire block
    base = dict(model=cfg3.name, tokenizer="byte", device="cuda",
                block_size=bs, num_kv_blocks=RS_KV_BLOCKS, max_num_seqs=4,
                seed=SEED, num_scheduler_steps=8, enable_lora=True,
                max_loras=2, max_lora_rank=RS_LORA_RANK,
                cpu_offload_bytes=320 * block_bytes, kv_restore_wait_s=30.0)
    root = Path(tempfile.mkdtemp(prefix="rank-set-", dir=REPO / "build"))
    counts = {}
    ref = LLMEngine(EngineConfig(**base))
    eng, boot = tp_engine(EngineConfig(**base, tensor_parallel_size=2))
    try:
        print(f"rank-set phase: {cfg3.name} tp=2 rank set (LoRA, the CPU "
              f"tier) up in {boot:.1f}s beside a tp=1 engine; the store "
              f"holds {eng.runner.reports()[0]['store_keys']} keys",
              flush=True)
        # (a) LoRA
        paths = {}
        for i, name in enumerate(("a1", "a2")):
            paths[name] = write_peft_adapter(
                str(root / name), lora_weights(torch, cfg3, RS_LORA_RANK,
                                               101 + i),
                lora_alpha=float(RS_LORA_RANK))
        for e in (ref, eng):
            for name, path in paths.items():
                e.load_lora(name, path)
        reps = eng.runner.reports(adapter_digests=True)
        full = ref.runner.lora_manager.buffers
        for r, rep in enumerate(reps):
            want = {k: tensor_digest(sharding.cut_adapter(k, v, r, 2))
                    for k, v in full.items()}
            if (rep["adapter_digests"] != want
                    or rep["adapters"] != ref.runner.lora_manager
                    .name_to_slot):
                fail(f"rank-set phase (a): rank {r}'s adapter buffers are "
                     "not its cut of tp=1's")
        # one-shot last-row logits of each lane, tp=2 against tp=1 (into
        # blocks no request holds yet)
        ids = [(7 * j + 5) % 250 + 1 for j in range(RS_LORA_ONESHOT_TOKENS)]
        table = list(range(1, 1 + -(-len(ids) // bs)))
        lanes = {}
        for name in (None, "a1", "a2"):
            slot = ref.runner.lora_manager.name_to_slot[name] if name else 0
            lanes[name] = [e.runner.prefill(ids, 0, table, len(ids),
                                            lora_slot=slot)[1].float().cpu()
                           for e in (ref, eng)]
        rels, moved = {}, {}
        for name, (want_l, got_l) in lanes.items():
            top = float(want_l.abs().max())
            rels[name] = float((got_l - want_l).abs().max()) / top
            # how far the adapter moves tp=2's lane from tp=1's base
            moved[name] = float((got_l - lanes[None][0]).abs().max()) / top
        print(f"rank-set phase (a): one-shot {len(ids)}-token last-row "
              f"logits max|d|/max|logit| tp=2 vs tp=1, base / a1 / a2: "
              f"{' / '.join(f'{v:.3e}' for v in rels.values())} (tol "
              f"{TP_LOGIT_REL_TOL}); the adapter lanes at tp=2 vs tp=1's "
              f"base: {moved['a1']:.3e} / {moved['a2']:.3e}", flush=True)
        if not (all(v <= TP_LOGIT_REL_TOL for v in rels.values())
                and min(moved["a1"], moved["a2"]) > TP_LOGIT_REL_TOL):
            fail(f"rank-set phase (a): adapter lane logits at tp=2 "
                 f"{rels}, moved from the base by {moved}")
        sp = SamplingParams(max_tokens=RS_LORA_TOKENS, temperature=0,
                            ignore_eos=True, logprobs=2)
        reqs = [([(7 * j + 5 * i) % 250 + 1 for j in range(60 + 40 * i)],
                 lora) for i, lora in enumerate((None, "a1", "a2", "a1"))]
        outs = {"tp1": drive_lora(ref, reqs, sp)}
        # after the tp=1 run: rank 0's process counts its launches too
        eng.runner.reset_counts()
        runs0 = [dict(r["dispatch_counts"]) for r in eng.runner.reports()]
        t0 = time.perf_counter()
        outs["tp2"] = drive_lora(eng, reqs, sp)
        wall = time.perf_counter() - t0
        counts["lora tp2"] = tp_rank_check(
            "rank-set phase (a) LoRA", eng.runner.reports(), TP_LAYERS,
            runs0)
        n_same = near_tie_check("rank-set phase (a) tp=2 vs tp=1 with "
                                "adapters", outs["tp1"], outs["tp2"],
                                gap_tol)
        if len({tuple(o.token_ids) for o in outs["tp2"][:3]}) < 3:
            fail("rank-set phase (a): an adapter's stream equals another's")
        answers = []
        for e in (ref, eng):
            e.unload_lora("a2")
            try:
                e.add_request("gone", prompt_token_ids=[1, 2, 3],
                              lora_name="a2", sampling_params=sp)
                answers.append(("served", e.list_loras()))
            except Exception as exc:  # noqa: BLE001 — compared below
                answers.append((type(exc).__name__, str(exc),
                                e.list_loras()))
        if answers[0] != answers[1] or answers[0][0] == "served":
            fail(f"rank-set phase (a): an unloaded adapter answers "
                 f"{answers[1]} at tp=2, {answers[0]} at tp=1")
        print(f"rank-set phase (a): two rank-{RS_LORA_RANK} PEFT adapters "
              f"loaded on every rank (each rank's buffers byte-equal to "
              f"its cut of tp=1's); {n_same}/{len(reqs)} greedy streams "
              f"(base and adapter lanes at once) equal to tp=1's in "
              f"{wall:.2f}s; an unloaded adapter answers {answers[1][:2]} "
              f"as at tp=1", flush=True)

        # (b) KV: export and import at tp=2, evict and restore
        prompt = [(17 * j + 5) % 250 + 1 for j in range(KV_PROMPT_TOKENS)]
        churn = [[(13 * j + 7 * i + 3) % 250 + 1
                  for j in range(KV_PROMPT_TOKENS)] for i in range(1, 5)]
        n_full = KV_PROMPT_TOKENS // bs
        sp = SamplingParams(max_tokens=16, temperature=0, ignore_eos=True,
                            logprobs=2)
        cold = eng.generate([prompt], sp)[0]
        bm = eng.block_manager
        bids = [bm.cached_blocks[h] for h in bm.block_hashes_for(prompt, 0)]
        free = [b for b in range(1, RS_KV_BLOCKS)
                if b not in bm.cached_blocks.values()
                and bm.blocks[b].ref_count == 0][:n_full]
        if len(bids) != n_full or len(free) != n_full:
            fail(f"rank-set phase (b): {len(bids)} cached and {len(free)} "
                 "free blocks")
        nbytes = n_full * block_bytes
        exp_s, imp_s = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data = eng.runner.export_blocks(bids)
            exp_s.append(time.perf_counter() - t0)
            host = data.clone()
            t0 = time.perf_counter()
            eng.runner.import_blocks(free, host)
            torch.cuda.synchronize()
            imp_s.append(time.perf_counter() - t0)
        back = eng.runner.export_blocks(free)
        digests = []
        for r, rep in enumerate(eng.runner.reports(kv_blocks=bids)):
            cut = data[:, :, :, r * nkv // 2:(r + 1) * nkv // 2]
            digests.append(rep["kv_digest"] == tensor_digest(cut))
        if not (torch.equal(back, data) and all(digests)):
            fail(f"rank-set phase (b): wire read back {torch.equal(back, data)}"
                 f", rank slices byte-equal {digests}")
        print(f"rank-set phase (b): {n_full} blocks of the "
              f"{KV_PROMPT_TOKENS}-token prompt ({nbytes / 2**20:.1f} MiB, "
              f"wire {tuple(data.shape)} {data.dtype}) exported at tp=2 "
              f"(each rank gathers its {nkv // 2} kv heads, rank 1 "
              f"broadcasts its slice through gloo, rank 0 assembles and "
              f"copies d2h) and "
              f"imported into {n_full} other blocks (rank 0 broadcasts the "
              f"wire, each rank scatters its heads): read back byte-equal, "
              f"every rank's slice byte-equal to its cut of the wire; "
              f"export {[round(t * 1e3, 2) for t in exp_s]} ms = best "
              f"{nbytes / min(exp_s) / 1e9:.2f} GB/s, import from pageable "
              f"memory {[round(t * 1e3, 2) for t in imp_s]} ms = best "
              f"{nbytes / min(imp_s) / 1e9:.2f} GB/s (host clock; tp=1 in "
              f"PR 8: 42.26 / 39.76 GB/s) on {smi}", flush=True)
        for c in churn:
            eng.generate([c], sp)
        r0 = eng._kv_restore_blocks_total
        eng.runner.reset_counts()
        runs0 = [dict(r["dispatch_counts"]) for r in eng.runner.reports()]
        warm = eng.generate([prompt], sp)[0]
        counts["kv tp2"] = tp_rank_check(
            "rank-set phase (b) restore", eng.runner.reports(), TP_LAYERS,
            runs0)
        restored = eng._kv_restore_blocks_total - r0
        fallbacks = eng._kv_restore_fallbacks_total
        n_same = near_tie_check("rank-set phase (b) restored vs cold",
                                [cold], [warm], gap_tol)
        print(f"rank-set phase (b): after {len(churn)} prompts of churn "
              f"the prompt "
              f"restored {restored} blocks from the CPU tier at tp=2 "
              f"(fallbacks {fallbacks}, export fallbacks "
              f"{eng._kv_export_sync_fallbacks_total}); its stream equal "
              f"to the cold one: {n_same == 1}", flush=True)
        if restored <= 0 or fallbacks:
            fail(f"rank-set phase (b): restored {restored} blocks with "
                 f"{fallbacks} fallbacks")

        # (c) PD: the tp=2 engine prefills and serves; a tp=1 decodes
        pd_prompt = [(23 * j + 11) % 250 + 1 for j in range(PD_PROMPT_TOKENS)]
        eng.generate([pd_prompt], SamplingParams(max_tokens=1,
                                                 temperature=0))
        # the reference first: a dropped engine's CUDA graphs must not be
        # freed while another runner captures (release below)
        want = ref.generate([pd_prompt], sp)[0]
        host = _TransferHost(eng)
        try:
            dec = LLMEngine(EngineConfig(
                model=cfg3.name, tokenizer="byte", device="cuda",
                block_size=bs, num_kv_blocks=RS_KV_BLOCKS, max_num_seqs=4,
                seed=SEED, kv_role="decode",
                kv_transfer_config={"peer": f"127.0.0.1:{host.port}"},
                kv_restore_wait_s=30.0))
            got = dec.generate([pd_prompt], sp)[0]
            pulls, hits = dec.kv_peer.pulls, dec.kv_peer.hits
            pd_restored = dec._kv_restore_blocks_total
            pd_fallbacks = dec._kv_restore_fallbacks_total
            dec.shutdown()
            del dec
            release(torch)
        finally:
            host.close()
        n_same = near_tie_check("rank-set phase (c) PD decode vs tp=1",
                                [want], [got], gap_tol)
        print(f"rank-set phase (c): a tp=1 decode engine pulled the "
              f"{PD_PROMPT_TOKENS}-token prompt's chain from the tp=2 "
              f"prefill engine: {pulls} pulls, {hits} blocks, "
              f"{pd_restored} restored, fallbacks {pd_fallbacks}; stream "
              f"equal to a tp=1 engine's: {n_same == 1}", flush=True)
        if pulls < 1 or pd_restored < 1 or pd_fallbacks:
            fail(f"rank-set phase (c): {pulls} pulls, {pd_restored} "
                 f"restored, {pd_fallbacks} fallbacks")
        keys = eng.runner.reports()[0]["store_keys"]
        print(f"rank-set phase: the set's store holds {keys} keys after "
              f"{eng.runner._bc.count} steps", flush=True)
    finally:
        stop(eng, f"rank-set phase {cfg3.name}")
        del ref
        release(torch)
        shutil.rmtree(root, ignore_errors=True)

    # (d) Mixtral-8x7B, MIXTRAL_LAYERS layers, float32, experts E/2 a rank
    cut = dataclasses.replace(mconfig.get_model_config("mixtral-8x7b"),
                              name=f"mixtral-8x7b-x{MIXTRAL_LAYERS}",
                              num_layers=MIXTRAL_LAYERS)
    mconfig._PRESETS[cut.name] = cut
    mbase = dict(model=cut.name, tokenizer="byte", device="cuda",
                 block_size=bs, num_kv_blocks=64, max_num_seqs=4, seed=SEED,
                 num_scheduler_steps=8, dtype="float32",
                 cache_dtype="float32")
    ids = [(5 * j + 3) % 250 + 1 for j in range(RS_MOE_ONESHOT_TOKENS)]
    table = list(range(1, 1 + -(-len(ids) // bs)))
    sp = SamplingParams(max_tokens=24, temperature=0, ignore_eos=True,
                        logprobs=2)
    k = cut.num_experts_per_tok
    spy = _GateSpy()
    try:
        def oneshot(runner):
            return spy.record(lambda: runner.prefill(ids, 0, table, len(ids))
                              [1].float().cpu())

        # the bfloat16 control: the same prefill at bf16 precision. The
        # tp=1 engines run eagerly: the spy records each block's input
        # from Python, which a captured prefill's replay does not run
        ctl = LLMEngine(EngineConfig(**{**mbase, "dtype": "bfloat16",
                                        "cache_dtype": "bfloat16"}),
                        eager=True)
        ctl_logits, ctl_rows = oneshot(ctl.runner)
        del ctl
        release(torch)
        ref = LLMEngine(EngineConfig(**mbase), eager=True)
        want_logits, want_rows = oneshot(ref.runner)
        want = ref.generate(RS_MOE_PROMPTS, sp)
        del ref
        release(torch)  # the rank set's experts take the card's room
        eng, boot = tp_engine(EngineConfig(**mbase,
                                           tensor_parallel_size=2))
        try:
            reps = eng.runner.reports()
            experts = [r["experts"] for r in reps]
            half = cut.num_experts // 2
            if experts != [[0, half], [half, cut.num_experts]]:
                fail(f"rank-set phase (d): experts a rank {experts}")
            held = eng.runner._runner.params["layers"]["w_gate"]
            got_logits, got_rows = oneshot(eng.runner)
            top = float(want_logits.abs().max())
            rel = float((got_logits - want_logits).abs().max()) / top
            ctl_rel = float((ctl_logits - want_logits).abs().max()) / top
            eng.runner.reset_counts()
            runs0 = [dict(r["dispatch_counts"])
                     for r in eng.runner.reports()]
            t0 = time.perf_counter()
            got = eng.generate(RS_MOE_PROMPTS, sp)
            wall = time.perf_counter() - t0
            counts["moe tp2"] = tp_rank_check(
                "rank-set phase (d) Mixtral EP", eng.runner.reports(),
                MIXTRAL_LAYERS, runs0)
            n_same = near_tie_check("rank-set phase (d) Mixtral tp=2 vs "
                                    "tp=1", want, got, gap_tol)
        finally:
            stop(eng, "rank-set phase Mixtral")
            release(torch)
    finally:
        spy.close()
    blocks = moe_parting(torch, want_rows, got_rows, k)
    ctl_blocks = moe_parting(torch, want_rows, ctl_rows, k)
    for i, (b, c) in enumerate(zip(blocks, ctl_blocks)):
        print(f"rank-set phase (d): layer {i} MoE input max|dx|/max|x| "
              f"{b['dx']:.3e} (bf16 control {c['dx']:.3e}), router "
              f"logits max|d| {b['dg']:.3e}, top-{k} parts at rows "
              f"{b['flips']} (largest tp=1 margin there {b['margin']:.3e}; "
              f"bf16 control parts at {len(c['flips'])} rows)", flush=True)
    first = next((i for i, b in enumerate(blocks) if b["flips"]),
                 len(blocks) - 1)
    print(f"rank-set phase (d): Mixtral-8x7B x{MIXTRAL_LAYERS} float32 at "
          f"tp=2 (rank set up in {boot:.1f}s; each rank holds experts "
          f"{experts} a layer, w_gate {tuple(held.shape)}): one-shot "
          f"{len(ids)}-token last-row logits max|d|/max|logit|={rel:.3e} "
          f"(tol {RS_MOE_LOGIT_REL_TOL}; bf16 control {ctl_rel:.3e}); "
          f"{n_same}/{len(want)} greedy streams equal to tp=1's, in "
          f"{wall:.2f}s (gloo through the host on one card, not an EP "
          f"speed)", flush=True)
    if not (torch.isfinite(got_logits).all()
            and all(b["dx"] <= RS_MOE_INPUT_REL_TOL
                    for b in blocks[:first + 1])
            and blocks[first]["margin"] <= blocks[first]["dg"]
            and rel <= RS_MOE_LOGIT_REL_TOL):
        fail(f"rank-set phase (d): EP parts from tp=1 beyond float32 "
             f"summation order: logits {rel:.3e}, blocks {blocks}")
    if not (ctl_blocks[0]["dx"] > RS_MOE_INPUT_REL_TOL
            and ctl_rel > RS_MOE_LOGIT_REL_TOL):
        fail(f"rank-set phase (d): the bf16 control reads {ctl_rel:.3e} "
             f"and {ctl_blocks[0]['dx']:.3e}, inside the float32 bounds")
    print(f"rank-set phase: {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return counts


# -- rank-set serving phase ------------------------------------------------------
# (e): the tp=2 engines' max_model_len, room for the mixed scenario
RSS_MAX_MODEL_LEN = 2048
# (f): the swept engine's max_model_len (the sweep's grid of ctx buckets
# ends there). At 2048 the sweep ran 79.68 s on an H100 80GB HBM3 at
# 700 W (eager, gloo through the host: ~0.11 s a decode forward, ~1.2 ms
# a prefill token), past the 60 s the phase allows it; at 256 it is the
# same grid's shape (4 ctx buckets, 7 chunk buckets, 4 decode variants)
RSS_SWEEP_MAX_MODEL_LEN = 256
# (f): the mixed scenario's long prompt inside that max_model_len
RSS_SWEEP_LONG_TOKENS = 120
# (g): the long-context phase's lane scenario at tp=2 x sp=2
RSS_LC_PROMPT_TOKENS = LC_PROMPT_TOKENS


def expected_sweep(cfg, num_blocks: int, variants: list) -> tuple[dict, int]:
    """The grid and the dispatch count of precompile_serving on a rank
    set of `cfg` with a pool of `num_blocks`, derived from the sweep's
    rules: ctx buckets of pow2 whole blocks up to the smaller of
    max_model_len and the pool; chunk buckets of pow2 rows from 8 to the
    chunk's; a single (chunk, ctx) for each chunk no longer than its ctx
    and a group of each pow2 size from 2 to max_prefill_seqs beside it,
    none dropped (a rank-set runner has no packed-prefill row buckets);
    one decode sweep a (K, chained, stop) variant over the ctx buckets
    shifted by K - 1, two dispatches a chained one; no ragged, verify or
    import sweep here. The sweeps skip a dispatch whose tables the pool
    cannot hold twice beside 64 blocks."""
    bs = cfg.block_size

    def pow2(n):
        p = 1
        while p < n:
            p *= 2
        return p

    top = pow2(-(-cfg.max_model_len // bs))

    def ctx_bucket(n):
        return min(pow2(max(1, -(-n // bs))), top) * bs

    cap = min(cfg.max_model_len, num_blocks * bs)
    ctxs = [ctx_bucket(1)]
    while ctxs[-1] < cap:
        ctxs.append(ctx_bucket(ctxs[-1] + 1))
    tbs = [8]
    while tbs[-1] < pow2(cfg.max_prefill_chunk):
        tbs.append(tbs[-1] * 2)
    singles = [(t, c) for c in ctxs for t in tbs if t <= c]
    sizes = [s for s in (2, 4, 8, 16, 32) if s <= cfg.max_prefill_seqs]
    groups = [(s, t, c) for t, c in singles for s in sizes]
    n = sum(num_blocks >= 2 * (c // bs) + 64 for _, c in singles)
    n += sum(num_blocks >= 2 * s * (c // bs) + 64 for s, _, c in groups)
    for k, chained, _ in variants:
        pads = {ctx_bucket(max(1, c - k + 1) + k - 1) for c in ctxs}
        n += sum((1 + (chained and k > 1)) for p in pads
                 if num_blocks >= 2 * (p // bs) + 64)
    grid = {"ctx_buckets": ctxs, "chunk_buckets": tbs,
            "singles": len(singles), "groups": len(groups),
            "decode_variants": variants}
    return grid, n


def rank_set_serving_phase(torch, pa, gap_tol: float, smi: str,
                           tp1_first) -> dict:
    """Async decode, the serving warm-up sweep and the long-prefill ring
    on Llama-3.2-3B tp=2 rank sets (full width, TP_LAYERS layers, bf16,
    seeded random weights, byte tokenizer; both ranks of a set on cuda:0
    over gloo, so no time here is a TP or sp speed). (f) A synchronous
    K=8 engine at
    max_model_len RSS_SWEEP_MAX_MODEL_LEN runs precompile_serving: its
    grid and count equal expected_sweep's for its config, every rank's
    dispatch counts grew by the same sweeps, summing to the count, and
    the mixed scenario (its long prompt cut to RSS_SWEEP_LONG_TOKENS to
    fit) gives the streams of an unswept tp=2 engine under the near-tie
    rule. (e) An async K=8 engine at max_model_len RSS_MAX_MODEL_LEN
    serves the tp phase's mixed scenario beside a synchronous one:
    streams held to each other under the near-tie rule, chained rounds
    > 0 on every rank, every follower's check of the chained tokens
    passed (the guard never fired: checks a rank equal the chained
    rounds and the set is alive), TP_LAYERS ragged launches a forward a
    rank; wall ms a token at batch 8 in turns async, sync, sync, async.
    (g) A lane engine (threshold
    LC_THRESHOLD, context_parallel_size LC_SP, chunk LC_CHUNK) and a
    chunked control at tp=2 serve the long-context phase's lane scenario
    with an RSS_LC_PROMPT_TOKENS-token prompt: streams held to the
    control's under the near-tie rule, the long prompt's first-token
    logits to the tp=1 lane's (`tp1_first`) within TP_LOGIT_REL_TOL of
    max|logit|, ceil(n / LC_CHUNK) chunks, 0 fallbacks, ceil(n / 32)
    blocks landed, no ring state left on the follower, TP_LAYERS ragged
    launches a forward a rank. Returns each driven run's launches a
    rank."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.engine.scheduler import (
        decode_precompile_variants,
    )
    from production_stack_tpu_torch.parallel.launch import start_tp_ranks

    t_phase = time.perf_counter()

    def tp_engine(cfg):
        t0 = time.perf_counter()
        group = start_tp_ranks(cfg, devices=["cuda:0", "cuda:0"],
                               backend="gloo")
        return LLMEngine(cfg, tp_group=group), time.perf_counter() - t0

    def stop(eng, what):
        followers = list(eng.tp_group.followers)
        eng.shutdown()
        codes = [p.exitcode for p in followers]
        if codes != [0] * len(followers):
            fail(f"{what}: followers exited with {codes}")

    def runs_of(reps, runs0):
        return [{k: v - r0[k] for k, v in r["dispatch_counts"].items()}
                for r, r0 in zip(reps, runs0)]

    counts = {}
    base = dict(model=cut_3b(), tokenizer="byte", device="cuda",
                block_size=32, num_kv_blocks=TP_KV_BLOCKS, max_num_seqs=8,
                seed=SEED, num_scheduler_steps=8,
                max_model_len=RSS_MAX_MODEL_LEN, tensor_parallel_size=2)
    sp = SamplingParams(max_tokens=32, temperature=0, ignore_eos=True,
                        logprobs=2)
    # (f) the sweep, on every rank of its own engine
    swept, boot = tp_engine(EngineConfig(
        **{**base, "max_model_len": RSS_SWEEP_MAX_MODEL_LEN}))
    try:
        cfg = swept.config
        sched = swept.scheduler.config
        variants = decode_precompile_variants(
            cfg.num_scheduler_steps, sched.adaptive_decode_k,
            overlap=swept._async_decode or swept._prefetch_decode,
            async_chained=swept._async_decode,
            device_stop=swept._device_stop)
        want_grid, want_n = expected_sweep(cfg, swept.runner.num_blocks,
                                           variants)
        runs0 = [dict(r["dispatch_counts"])
                 for r in swept.runner.reports()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = swept.precompile_serving()
        sweep_s = time.perf_counter() - t0
        runs = runs_of(swept.runner.reports(), runs0)
        total = sum(runs[0][k] for k in ("prefill", "prefill_batch",
                                          "decode", "decode_multi"))
        print(f"rank-set serving phase (f): tp=2 rank set up in "
              f"{boot:.1f}s; precompile_serving at max_model_len "
              f"{RSS_SWEEP_MAX_MODEL_LEN}: {n} dispatches in "
              f"{sweep_s:.2f}s (host clock, every rank eager: no program "
              f"variant, no graph; compile events "
              f"{swept.runner.compile_events_total}); grid "
              f"{swept.precompile_grid}; every rank's dispatches {runs}",
              flush=True)
        if swept.precompile_grid != want_grid or n != want_n:
            fail(f"rank-set serving phase (f): grid "
                 f"{swept.precompile_grid} and count {n}, not {want_grid} "
                 f"and {want_n}")
        if (any(r != runs[0] for r in runs) or total != n
                or swept.runner.compile_events_total):
            fail(f"rank-set serving phase (f): the ranks' sweeps {runs} "
                 f"for {n} dispatches")
        # turn 1: prompts that share no prefix with (e)'s turn 0, whose
        # cached blocks would change the sync engine's prefill there
        short = {"swept": staggered_mix(torch, pa, swept, "rss-swept", 1,
                                        sp, n_long=RSS_SWEEP_LONG_TOKENS)[0]}
    finally:
        stop(swept, "rank-set serving phase (f)")
        del swept
        release(torch)
    sync, boot = tp_engine(EngineConfig(**base))
    engs = {"sync": sync}
    try:
        short["unswept"] = staggered_mix(torch, pa, sync, "rss-swept", 1, sp,
                                         n_long=RSS_SWEEP_LONG_TOKENS)[0]
        n_same = near_tie_check("rank-set serving phase (f) swept vs "
                                "unswept", short["unswept"], short["swept"],
                                gap_tol)
        print(f"rank-set serving phase (f): the mixed scenario with a "
              f"{RSS_SWEEP_LONG_TOKENS}-token prompt: {n_same}/5 greedy "
              f"streams of the swept engine equal to an unswept tp=2 "
              f"engine's", flush=True)
        asy, boot = tp_engine(EngineConfig(**base, async_decode=True))
        engs["async"] = asy
        print(f"rank-set serving phase (e): async tp=2 rank set up in "
              f"{boot:.1f}s; async decode {asy._async_decode}, ragged "
              f"rounds {asy._ragged_dispatch}", flush=True)
        # (e) the tp phase's mixed scenario on both
        outs, walls = {}, {}
        for tag in ("sync", "async"):
            e = engs[tag]
            e.runner.reset_counts()
            runs0 = [dict(r["dispatch_counts"]) for r in e.runner.reports()]
            outs[tag], _, _, _, walls[tag] = staggered_mix(
                torch, pa, e, f"rss-{tag}", 0, sp)
            reps = e.runner.reports()
            got = tp_rank_check(f"rank-set serving phase (e) {tag}", reps,
                                TP_LAYERS, runs0)
            if tag == "async":
                # a fresh engine: its lifetime counts are the scenario's
                counts["async tp2"] = got
                chained = [r["chained_rounds"] for r in reps]
                checks = [r["chain_checks"] for r in reps]
        n_same = near_tie_check("rank-set serving phase (e) async vs "
                                "sync", outs["sync"], outs["async"],
                                gap_tol)
        print(f"rank-set serving phase (e): {n_same}/5 greedy streams of "
              f"the async tp=2 engine equal to the sync engine's; "
              f"chained rounds a rank {chained}, token checks a rank "
              f"(rank 0 sent, the follower passed) {checks}; the "
              f"scenario's wall {walls['async']:.2f}s async, "
              f"{walls['sync']:.2f}s sync; launches a rank "
              f"{counts['async tp2']}", flush=True)
        if (min(chained) < 1 or len(set(chained)) != 1
                or checks != [checks[0]] * 2 or checks[0] < chained[0]
                or not asy.tp_alive()):
            fail(f"rank-set serving phase (e): chained {chained}, checks "
                 f"{checks}, alive {asy.tp_alive()}")
        ms = {"async": [], "sync": []}
        for turn, tag in enumerate(("async", "sync", "sync", "async")):
            ms[tag].append(decode_batch8(torch, engs[tag], f"rss-{tag}-b8",
                                         turn))
        print(f"rank-set serving phase (e): wall ms a generated token at "
              f"batch 8 (K=8, host clock, turns async, sync, sync, async; "
              f"gloo through the host with both ranks on one card): async "
              f"{', '.join(f'{x:.3f}' for x in ms['async'])}; sync "
              f"{', '.join(f'{x:.3f}' for x in ms['sync'])} ({smi})",
              flush=True)
    finally:
        for tag, e in engs.items():
            stop(e, f"rank-set serving phase {tag}")
        del engs, sync
        release(torch)

    # (g) the ring at tp=2 x sp=2 beside the chunked tp=2 control
    t_g = time.perf_counter()
    n_long = RSS_LC_PROMPT_TOKENS
    lbase = dict(model=base["model"], tokenizer="byte", device="cuda",
                 block_size=32, num_kv_blocks=640, max_num_seqs=8,
                 seed=SEED, tensor_parallel_size=2)
    sp = SamplingParams(max_tokens=LC_DECODE_TOKENS, temperature=0,
                        ignore_eos=True, logprobs=2)
    res = {}
    for tag, lane in (("lane", True), ("chunked", False)):
        over = (dict(long_prefill_threshold=LC_THRESHOLD,
                     context_parallel_size=LC_SP,
                     long_prefill_chunk=LC_CHUNK) if lane else {})
        eng, boot = tp_engine(EngineConfig(**lbase, **over))
        try:
            first = None
            if lane:
                mgr = eng.long_prefill
                if (mgr is None or mgr.prefiller.tp_group is None
                        or any(d.type != "cuda"
                               for d in mgr.prefiller.devices)):
                    fail("rank-set serving phase (g): the lane is not live "
                         "on the tp ranks")
                first = lane_logits(mgr)
            eng.runner.reset_counts()
            runs0 = [dict(r["dispatch_counts"])
                     for r in eng.runner.reports()]
            r = lc_scenario(torch, pa, eng, f"rss-{tag}-", sp, n_long)
            reps = eng.runner.reports()
            r["ranks"] = tp_rank_check(f"rank-set serving phase (g) {tag}",
                                       reps, TP_LAYERS, runs0)
            r["lane_jobs"] = [rep["lane_jobs"] for rep in reps]
            r["stats"] = eng.stats()
            r["boot"] = boot
            if lane:
                r["first"] = first.get("rss-lane-long")
                r["collect_s"] = mgr.collect_s_total
                tl = {t["request_id"]: t
                      for t in eng.timeline.snapshot(limit=256)}
                evs = [e for e in tl["rss-lane-long"]["events"]
                       if e["name"] == "long_prefill"]
                r["event"] = evs[0]["attributes"] if evs else None
            res[tag] = r
        finally:
            stop(eng, f"rank-set serving phase (g) {tag}")
            del eng
            release(torch)
    lane, ctrl = res["lane"], res["chunked"]
    counts["lane tp2"] = lane["ranks"]
    st = lane["stats"]
    n_chunks = -(-n_long // LC_CHUNK)
    n_blocks = -(-n_long // 32)
    counters = (st.long_prefill_requests_total, st.long_prefill_chunks_total,
                st.long_prefill_fallbacks_total)
    landed = lane["event"]["blocks_landed"] if lane["event"] else None
    want_l = tp1_first.float()
    got_l = lane["first"]
    rel = (float((got_l - want_l).abs().max()) / float(want_l.abs().max())
           if got_l is not None else float("inf"))
    n_same = near_tie_check("rank-set serving phase (g) lane vs chunked at "
                            "tp=2", ctrl["outs"], lane["outs"], gap_tol)

    def ms(xs):
        return (f"median {sorted(xs)[len(xs) // 2]:.2f} ms, max "
                f"{max(xs):.2f} over {len(xs)}" if xs else "none")

    print(f"rank-set serving phase (g): tp=2 x sp=2 lane engine up in "
          f"{lane['boot']:.1f}s; requests, chunks, fallbacks {counters} "
          f"(chunks wanted {n_chunks}); blocks landed {landed} (wanted "
          f"{n_blocks}); ring state left on the ranks {lane['lane_jobs']}; "
          f"the long prompt's first-token logits max|d|/max|logit| "
          f"{rel:.3e} from the tp=1 lane's (tol {TP_LOGIT_REL_TOL}); "
          f"{n_same}/5 greedy streams equal to the chunked tp=2 "
          f"control's; launches a rank {lane['ranks']}", flush=True)
    print(f"rank-set serving phase (g): TTFT of the {n_long}-token prompt: "
          f"ring {lane['ttft']:.3f}s, chunked {ctrl['ttft']:.3f}s (host "
          f"clock); the collect (rank 1's kv heads of the ring cache "
          f"through gloo to rank 0) {lane['collect_s']:.3f}s; ring / d2h "
          f"/ land seconds {st.long_prefill_ring_seconds_total:.3f} / "
          f"{st.long_prefill_d2h_seconds_total:.3f} / "
          f"{st.long_prefill_land_seconds_total:.3f}; step-thread host ms "
          f"a chunk {[round(x, 1) for x in lane['chunk_ms']]}; ITL of the "
          f"four decoders (step wall): lane engine in a step that "
          f"dispatched a ring chunk {ms(lane['itl']['chunk'])}, with the "
          f"collect, d2h or landing in flight "
          f"{ms(lane['itl']['in flight'])}, without a ring "
          f"{ms(lane['itl']['none'])}; chunked engine with the prompt's "
          f"chunks in flight {ms(ctrl['itl']['in flight'])}, without "
          f"{ms(ctrl['itl']['none'])}; memory peak {lane['peak_gb']:.2f} / "
          f"{ctrl['peak_gb']:.2f} GB (rank 0's process); the (g) part "
          f"{time.perf_counter() - t_g:.1f}s; every rank on one card over "
          f"gloo: not tp or sp speeds; on {smi}", flush=True)
    if (counters != (1, n_chunks, 0) or landed != n_blocks
            or lane["lane_jobs"] != [0, 0] or not rel <= TP_LOGIT_REL_TOL
            or lane["collect_s"] <= 0
            or ctrl["stats"].long_prefill_requests_total):
        fail(f"rank-set serving phase (g): counters {counters}, landed "
             f"{landed}, ring state {lane['lane_jobs']}, logits {rel:.3e}, "
             f"collect {lane['collect_s']}")
    print(f"rank-set serving phase: {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return counts


# -- stack phase: the port's router in front of port engines ----------------------
STACK_KV_BLOCKS = 512       # 16384 tokens a both-role engine
STACK_PREFIX_CHARS = 1500   # byte tokenizer: 1501 tokens with BOS
STACK_PD_TOKENS = PD_PROMPT_TOKENS
STACK_TOKENS = 16
STACK_TTFT_REQUESTS = 16
STACK_TTFT_TOKENS = 32
STACK_KV_THRESHOLD = 1024   # kvaware: matched tokens that decide a pick
STACK_HEALTH_WINDOW_S = 60.0


def router_cmd(port: int, backends: list[int], logic: str,
               extra: tuple = (), model: str = "llama-3.2-3b") -> list[str]:
    """`python -m production_stack_tpu_torch.router` in front of local
    engines, as a user starts it."""
    return [sys.executable, "-m", "production_stack_tpu_torch.router",
            "--host", "127.0.0.1", "--port", str(port),
            "--service-discovery", "static",
            "--static-backends",
            ",".join(f"http://127.0.0.1:{p}" for p in backends),
            "--static-models", ",".join(model for _ in backends),
            "--routing-logic", logic, "--engine-stats-interval", "1",
            *extra]


def start_router(cmd: list[str], log_path: Path):
    """The router in a child process -> (proc, seconds until /health)."""
    port = int(cmd[cmd.index("--port") + 1])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    print(f"router: {' '.join(cmd[1:])}", flush=True)
    t0 = time.perf_counter()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
    while True:  # wait_healthy's polls, every 20 ms: a router boots fast
        if proc.poll() is not None:
            fail(f"router exited with {proc.returncode}:\n"
                 f"{log_tail(log_path)}")
        if time.perf_counter() - t0 > 60:
            fail(f"router not healthy after 60 s:\n{log_tail(log_path)}")
        try:
            if http(port, "/health", timeout=5)[0] == 200:
                return proc, time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.02)


class SseStream:
    """A streamed completion or chat read line by line over HTTP:
    token ids (completions: "token_id:N"; chat: the token strings) and
    top-2 logprobs a step, shaped as near_tie_check reads a
    RequestOutput, plus the client's time to the first event and to the
    end."""

    def __init__(self, port: int, path: str, body: dict,
                 headers: dict | None = None, timeout: float = 600.0):
        from http.client import HTTPConnection

        conn = HTTPConnection("127.0.0.1", port, timeout=timeout)
        t0 = time.perf_counter()
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        self.status = r.status
        self.headers = dict(r.getheaders())
        self.ttft = None
        self.done = False
        self.token_ids: list = []
        self.logprobs: list = []
        self.text = ""
        while True:
            line = r.readline()
            if not line:
                break
            if not line.startswith(b"data: "):
                continue
            if self.ttft is None:
                self.ttft = time.perf_counter() - t0
            data = line[6:].strip()
            if data == b"[DONE]":
                self.done = True
                continue
            ch = json.loads(data)["choices"][0]
            self.text += ch.get("text") or ch.get("delta", {}).get(
                "content") or ""
            lp = ch.get("logprobs")
            if not lp:
                continue
            if "content" in lp:  # chat: [{token, logprob, top_logprobs}]
                for e in lp["content"]:
                    self.token_ids.append(e["token"])
                    self.logprobs.append({"top_logprobs": [
                        {"logprob": t["logprob"]} for t in sorted(
                            e["top_logprobs"], key=lambda t: -t["logprob"])]})
            else:
                self.token_ids += [int(t.split(":")[1])
                                   for t in lp["tokens"]]
                self.logprobs += [{"top_logprobs": [
                    {"logprob": v} for v in sorted(top.values(),
                                                   reverse=True)]}
                    for top in lp["top_logprobs"]]
        self.e2e = time.perf_counter() - t0
        conn.close()


def stack_request(prompt, chat: bool, tokens: int = STACK_TOKENS,
                  model: str = "llama-3.2-3b") -> tuple:
    """(path, body) of a greedy streamed request with top-2 logprobs."""
    body = {"model": model, "max_tokens": tokens,
            "temperature": 0, "ignore_eos": True, "stream": True}
    if chat:
        return "/v1/chat/completions", {
            **body, "messages": [{"role": "user", "content": prompt}],
            "logprobs": True, "top_logprobs": 2}
    return "/v1/completions", {**body, "prompt": prompt, "logprobs": 2,
                               "return_tokens_as_token_ids": True}


def served_counts(ports: list[int]) -> list[float]:
    """Requests each engine finished, from its /metrics."""
    return [metric(p, "vllm:e2e_request_latency_seconds_count")
            for p in ports]


def settle_counts(ports: list[int], before: list[float], n: int) -> list:
    """The engines' finished-request deltas once they add up to n (an
    engine counts a request as it finishes, a moment after its last
    event)."""
    t0 = time.perf_counter()
    while True:
        d = [a - b for a, b in zip(served_counts(ports), before)]
        if sum(d) >= n or time.perf_counter() - t0 > 10:
            return d
        time.sleep(0.1)


def router_served(port: int) -> dict:
    """The router's finished proxy attempts a backend port, all
    outcomes, read with the port's Prometheus parser."""
    samples, types = parse_metrics(http(port, "/metrics")[1])
    for name in ("tpu_router:requests_total", "vllm:healthy_pods_total",
                 "tpu_router:routing_decision_seconds"):
        if name not in types:
            fail(f"stack phase: the router's /metrics has no {name}")
    out: dict[int, float] = {}
    for labels, v in samples.get("tpu_router:requests_total", []):
        p = int(labels["server"].rsplit(":", 1)[1])
        out[p] = out.get(p, 0.0) + v
    return out


def routing_decision_us(port: int) -> float:
    """Mean routing decision (µs) over the router's requests, from its
    tpu_router:routing_decision_seconds histogram."""
    samples, _ = parse_metrics(http(port, "/metrics")[1])
    tot = sum(v for _, v in samples.get(
        "tpu_router:routing_decision_seconds_sum", []))
    n = sum(v for _, v in samples.get(
        "tpu_router:routing_decision_seconds_count", []))
    return tot / n * 1e6 if n else float("nan")


def prefix_hash_us(n_chars: int = STACK_PREFIX_CHARS, reps: int = 200
                   ) -> float:
    """Host µs a request of prefixaware routing spends hashing: one
    longest-prefix match and one insert of an n_chars prompt into the
    router's HashTrie (128-char chunks on the pure-Python xxh64), the
    trie already holding it."""
    import asyncio

    from production_stack_tpu_torch.router.hashtrie import HashTrie

    text = "".join(chr(97 + (7 * j) % 26) for j in range(n_chars))

    async def run() -> float:
        trie = HashTrie()
        await trie.insert(text, "a")
        t0 = time.perf_counter()
        for _ in range(reps):
            await trie.longest_prefix_match(text, {"a"})
            await trie.insert(text, "a")
        return (time.perf_counter() - t0) / reps * 1e6

    return asyncio.run(run())


def stack_phase(torch, gap_tol: float, smi: str,
                model: str = "llama-3.2-3b", device: str = "cuda") -> dict:
    """The whole port stack on one card: port engines (the CLI at its
    defaults on `model`: main hands it the 3B at full width and
    CKPT_LAYERS layers as a checkpoint, random weights from SEED; byte
    tokenizer) behind the port's router (`python -m
    production_stack_tpu_torch.router`), each process started as a user
    starts it. `model` and `device` also serve a dry run of the phase's
    logic on a CPU with a tiny model."""
    import functools
    from concurrent.futures import ThreadPoolExecutor as Pool

    from production_stack_tpu_torch.kv.controller import KVControllerClient
    from production_stack_tpu_torch.models.config import get_model_config

    layers = get_model_config(model).num_layers

    req = functools.partial(stack_request, model=model)
    rcmd = functools.partial(router_cmd, model=model)

    build = REPO / "build"
    procs: list = []
    ctl_port = free_port()
    names = ("a", "b", "prefill", "decode")
    ports = {n: free_port() for n in names}
    kv_port = free_port()
    dev = () if device == "cuda" else ("--device", device)
    both = dev + ("--num-kv-blocks", str(STACK_KV_BLOCKS),
                  "--kv-controller-url", f"127.0.0.1:{ctl_port}")
    extra = {
        "a": both, "b": both,
        "prefill": dev + ("--num-kv-blocks", str(STACK_KV_BLOCKS),
                          "--kv-role", "prefill",
                          "--kv-transfer-listen", f"127.0.0.1:{kv_port}"),
        "decode": dev + ("--num-kv-blocks", str(STACK_KV_BLOCKS),
                         "--kv-role", "kv_consumer",
                         "--kv-peer", f"127.0.0.1:{kv_port}"),
    }
    logs = {n: build / f"chip_smoke_stack_{n}_serve.log" for n in names}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    build.mkdir(parents=True, exist_ok=True)
    ctl_log = build / "chip_smoke_stack_controller.log"
    boots: list[float] = []
    counts: dict = {}
    routers: list = []
    t_phase = time.perf_counter()
    try:
        with open(ctl_log, "wb") as log:
            procs.append(subprocess.Popen(
                # on every address, as by default: a router then finds
                # the port taken and connects to it instead of embedding
                # a controller of its own on 0.0.0.0
                [sys.executable, "-m", "production_stack_tpu_torch.kv."
                 "controller", "--port", str(ctl_port)], cwd=REPO, env=env,
                stdout=log,
                stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        eng = {n: start_server(ports[n], logs[n], model, extra[n])
               for n in names}
        procs += list(eng.values())
        for n in names:
            wait_healthy(f"stack {n}", eng[n], ports[n], logs[n], t0)
            http(ports[n], "/debug/kernel_launches", method="DELETE")
        print(f"stack phase: 4 engines (two both-role with "
              f"{STACK_KV_BLOCKS} KV blocks and the controller, prefill, "
              f"decode) healthy in {time.perf_counter() - t0:.1f}s",
              flush=True)
        pa_, pb = ports["a"], ports["b"]
        short = [f"Stack request {i}: " + "".join(
            chr(97 + (5 * j + 3 * i) % 26) for j in range(160))
            for i in range(8)]

        def prefixed(seed: int) -> list[str]:
            pre = "".join(chr(65 + (seed * 11 + 7 * j) % 26)
                          for j in range(STACK_PREFIX_CHARS))
            return [pre + f" suffix {i}." for i in range(8)]

        def direct(reqs) -> list:
            return [SseStream(pa_, *req(p, chat))
                    for p, chat in reqs]

        def check_streams(what: str, got: list, want: list) -> None:
            bad = [i for i, s in enumerate(got)
                   if s.status != 200 or not s.done
                   or len(s.token_ids) != len(want[i].token_ids)]
            if bad:
                fail(f"stack phase {what}: requests {bad} answered "
                     f"{[got[i].status for i in bad]} or cut short")
            n_same = near_tie_check(f"stack phase {what}", want, got,
                                    gap_tol)
            print(f"stack phase {what}: {n_same}/{len(got)} router "
                  "streams equal to the direct ones", flush=True)

        def run_router(logic: str, reqs, extra_args=(), headers=None,
                       check=None) -> tuple:
            rport = free_port()
            proc, boot = start_router(
                rcmd(rport, [pa_, pb], logic, extra_args),
                build / f"chip_smoke_stack_router_{logic}.log")
            routers.append(proc)
            boots.append(boot)
            before = served_counts([pa_, pb])
            got = []
            for i, (p, chat) in enumerate(reqs):
                got.append(SseStream(rport, *req(p, chat),
                                     headers=headers))
                if check is not None:
                    check(i, rport)
            d = settle_counts([pa_, pb], before, len(reqs))
            served = router_served(rport)
            if [served.get(pa_, 0.0), served.get(pb, 0.0)] != d:
                fail(f"stack phase {logic}: the router counts "
                     f"{served} requests a backend, the engines {d}")
            dec_us = routing_decision_us(rport)
            stop_server(proc)
            routers.remove(proc)
            print(f"stack phase {logic}: engines served {d}, router "
                  f"boot {boot:.2f}s, routing decision "
                  f"{dec_us:.0f} us a request (router host clock)",
                  flush=True)
            return got, d, dec_us

        mixed = [(p, i % 2 == 1) for i, p in enumerate(short)]
        want_mixed = None
        # roundrobin: 2N requests split N and N
        got, d, _ = run_router("roundrobin", mixed)
        want_mixed = direct(mixed)
        check_streams("roundrobin", got, want_mixed)
        if d != [4.0, 4.0]:
            fail(f"stack phase roundrobin: split {d}, want [4, 4]")
        # session: every request of one session on one engine
        got, d, _ = run_router("session", mixed,
                               ("--session-key", "x-user-id"),
                               headers={"x-user-id": "alice"})
        check_streams("session", got, want_mixed)
        if sorted(d) != [0.0, 8.0]:
            fail(f"stack phase session: one session spread as {d}")
        hits_of = lambda: [metric(p, "vllm:gpu_prefix_cache_hits_total")
                           for p in (pa_, pb)]
        dec_prefix = None
        for logic, seed, extra_args in (
                ("prefixaware", 1, ()),
                ("kvaware", 2, ("--kv-controller-url",
                                f"127.0.0.1:{ctl_port}",
                                "--kv-aware-threshold",
                                str(STACK_KV_THRESHOLD)))):
            reqs = [(p, False) for p in prefixed(seed)]
            first: list = []

            def after_first(i, rport, first=first, reqs=reqs):
                if i != 0:
                    return
                # the first request's engine, and (kvaware) its blocks
                # reported to the controller before the next request
                d0 = settle_counts([pa_, pb], before_hits[1], 1)
                first.append(0 if d0[0] else 1)
                if logic != "kvaware":
                    return
                import asyncio

                from production_stack_tpu_torch.engine.tokenizer import (
                    ByteTokenizer,
                )

                toks = ByteTokenizer().encode(reqs[0][0])

                async def probe() -> dict:
                    c = KVControllerClient("127.0.0.1", ctl_port)
                    try:
                        return await c.lookup(toks)
                    finally:
                        await c.close()

                t1 = time.perf_counter()
                while max(asyncio.run(probe()).values(),
                          default=0) < STACK_KV_THRESHOLD:
                    if time.perf_counter() - t1 > 30:
                        fail("stack phase kvaware: the controller never "
                             "held the first request's blocks")
                    time.sleep(0.1)

            before_hits = (hits_of(), served_counts([pa_, pb]))
            got, d, dec_us = run_router(logic, reqs, extra_args,
                                        check=after_first)
            hits = [a - b for a, b in zip(hits_of(), before_hits[0])]
            e = first[0]
            if d[e] != 8.0 or d[1 - e] != 0.0:
                fail(f"stack phase {logic}: the shared-prefix requests "
                     f"spread as {d}; the first went to engine {e}")
            if not hits[e] > 0 or hits[1 - e] != 0:
                fail(f"stack phase {logic}: prefix-cache hits {hits}")
            print(f"stack phase {logic}: 8 requests sharing a "
                  f"{STACK_PREFIX_CHARS}-char prefix all on engine "
                  f"{'ab'[e]} (the first's), its prefix-cache hits "
                  f"+{hits[e]:.0f}, the other's +{hits[1 - e]:.0f}",
                  flush=True)
            check_streams(logic, got, direct(reqs))
            if logic == "prefixaware":
                dec_prefix = dec_us
        few = mixed[:4]
        got, _, _ = run_router("ttft", few)
        check_streams("ttft", got, want_mixed[:4])

        # latency: and TTFT through the router against direct
        rport = free_port()
        proc, boot = start_router(rcmd(rport, [pa_, pb], "latency"),
                                  build / "chip_smoke_stack_router_"
                                  "latency.log")
        routers.append(proc)
        boots.append(boot)
        got = [SseStream(rport, *req(p, c)) for p, c in few]
        check_streams("latency", got, want_mixed[:4])
        ttft = {"direct": [], "router": [], "router_e2e": []}
        for i in range(STACK_TTFT_REQUESTS):
            p = f"TTFT probe {i}: " + short[i % 8][20:120]
            path, body = req(p, False, STACK_TTFT_TOKENS)
            order = (("direct", pa_), ("router", rport))
            for kind, port in (order if i % 2 == 0 else order[::-1]):
                s = SseStream(port, path, body)
                if s.status != 200 or not s.done:
                    fail(f"stack phase TTFT {kind}: {s.status}")
                ttft[kind].append(s.ttft)
                if kind == "router":
                    ttft["router_e2e"].append(s.e2e)
        stop_server(proc)
        routers.remove(proc)

        def pct(xs, q):
            xs = sorted(xs)
            return xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3

        print(f"stack phase TTFT over {STACK_TTFT_REQUESTS} streamed "
              f"requests ({STACK_TTFT_TOKENS} tokens each): direct p50 "
              f"{pct(ttft['direct'], .5):.2f} ms p90 "
              f"{pct(ttft['direct'], .9):.2f} ms; through the router p50 "
              f"{pct(ttft['router'], .5):.2f} ms p90 "
              f"{pct(ttft['router'], .9):.2f} ms (client host clock) on "
              f"{smi}", flush=True)
        if not pct(ttft["router"], .5) < 0.5 * pct(ttft["router_e2e"], .5):
            fail("stack phase: through the router the first event comes "
                 f"at {pct(ttft['router'], .5):.1f} ms of a "
                 f"{pct(ttft['router_e2e'], .5):.1f} ms stream (p50): the "
                 "router buffers instead of streaming")
        hash_us = prefix_hash_us()
        print(f"stack phase: prefixaware hashing of a "
              f"{STACK_PREFIX_CHARS}-char prompt {hash_us:.1f} us a "
              f"request (pure-Python xxh64, host clock); the router's "
              f"mean routing decision under prefixaware "
              f"{dec_prefix:.0f} us; router boot {min(boots):.2f}-"
              f"{max(boots):.2f}s over {len(boots)} starts on {smi}",
              flush=True)

        # PD: prefill-role and decode-role engines behind the router
        pp, dp = ports["prefill"], ports["decode"]
        n_pd = STACK_PD_TOKENS // 32
        for j, (logic, extra_args) in enumerate((
                ("pd", ()),
                ("disaggregated_prefill",
                 ("--static-model-labels", "prefill,decode",
                  "--prefill-model-labels", "prefill",
                  "--decode-model-labels", "decode")))):
            ids = [(7 * k + 11 + 5 * j) % 250 + 1
                   for k in range(STACK_PD_TOKENS)]
            before = {p: parse_metrics(http(p, "/metrics")[1])[0]
                      for p in (pp, dp)}
            rport = free_port()
            proc, boot = start_router(
                rcmd(rport, [pp, dp], logic, extra_args),
                build / f"chip_smoke_stack_router_{logic}.log")
            routers.append(proc)
            boots.append(boot)
            got = SseStream(rport, *req(ids, False))
            stop_server(proc)
            routers.remove(proc)
            after = {p: parse_metrics(http(p, "/metrics")[1])[0]
                     for p in (pp, dp)}

            def delta(p, name):
                return (after[p].get(name, [({}, 0.0)])[0][1]
                        - before[p].get(name, [({}, 0.0)])[0][1])

            pd = {
                "prefill served": delta(
                    pp, "vllm:e2e_request_latency_seconds_count"),
                "decode served": delta(
                    dp, "vllm:e2e_request_latency_seconds_count"),
                "peer hits": delta(dp, "tpu:kv_peer_hits_total"),
                "restored blocks": delta(dp, "tpu:kv_restore_blocks_total"),
                "peer fallbacks": delta(dp, "tpu:kv_peer_fallbacks_total"),
                "restore fallbacks": delta(
                    dp, "tpu:kv_restore_fallbacks_total"),
            }
            want = {"prefill served": 1.0, "decode served": 1.0,
                    "peer hits": float(n_pd),
                    "restored blocks": float(n_pd), "peer fallbacks": 0.0,
                    "restore fallbacks": 0.0}
            print(f"stack phase {logic}: {STACK_PD_TOKENS}-token prompt, "
                  f"router boot {boot:.2f}s, engines' counters {pd}",
                  flush=True)
            if pd != want:
                fail(f"stack phase {logic}: {pd}, want {want} (one chain "
                     f"pull of {n_pd} blocks, no fallback)")
            check_streams(logic, [got], direct([(ids, False)]))

        for n in names:
            report = json.loads(http(ports[n], "/debug/kernel_launches")[1])
            if device == "cuda":
                check_launches(f"stack phase engine {n}",
                               report["launches"], report["dispatches"],
                               layers=layers)
            counts[n] = report["launches"]

        # health: SIGTERM one engine under a steady load
        rport = free_port()
        proc, boot = start_router(
            rcmd(rport, [pa_, pb], "roundrobin", (
                "--static-backend-health-checks",
                "--backend-health-check-timeout-seconds", "1")),
            build / "chip_smoke_stack_router_health.log")
        routers.append(proc)
        boots.append(boot)
        statuses: list = []
        stop_load = False

        def load() -> None:
            i = 0
            while not stop_load:
                try:
                    st, _ = http(rport, "/v1/completions", {
                        "model": model, "max_tokens": 4,
                        "temperature": 0, "ignore_eos": True,
                        "prompt": short[i % 8]})
                except OSError as e:
                    st = f"error {e}"
                statuses.append(st)
                i += 1

        with Pool(3) as pool:
            jobs = [pool.submit(load) for _ in range(2)]
            while len(statuses) < 8:
                time.sleep(0.05)
            # a stream in flight on engine b when it is SIGTERMed: sent
            # after the load's first 8 answers, the signal once its
            # response head has come; the engine stops listening,
            # finishes it, then stops
            started = threading.Event()
            stream = pool.submit(sse_stream, pb, {
                "model": model, "max_tokens": STACK_SIGTERM_TOKENS,
                "temperature": 0, "ignore_eos": True,
                "prompt": short[0]}, started=started)
            if not started.wait(60):
                stop_load = True
                fail("stack phase health: engine b sent no response head "
                     "for the stream in 60 s")
            t_kill = time.perf_counter()
            eng["b"].send_signal(signal.SIGTERM)
            rc_b = eng["b"].wait(60)
            streamed = stream.result(60)
            stopped = "engine server stopped" in logs["b"].read_text()
            after = {k: None if streamed[k] is None
                     else round(streamed[k] - t_kill, 4)
                     for k in ("t_head", "t_last_event", "t_done")}
            print(f"stack phase health: engine b exited {rc_b} "
                  f"{time.perf_counter() - t_kill:.2f}s after SIGTERM; its "
                  f"in-flight stream: {streamed['events']} data events, "
                  f"finish {streamed['finish']}, [DONE] "
                  f"{streamed['done']}, seconds after SIGTERM of its head, "
                  f"last event and [DONE] {after}; shutdown logged: "
                  f"{stopped}", flush=True)
            mid = (after["t_head"] is not None and after["t_head"] <= 0
                   and after["t_last_event"] is not None
                   and after["t_last_event"] > 0
                   and after["t_done"] is not None and after["t_done"] > 0)
            if rc_b != 0 or not stopped or not streamed["done"] or (
                    streamed["finish"] != "length") or not mid:
                stop_load = True
                fail("stack phase health: the SIGTERMed engine did not "
                     f"finish its stream in flight and stop cleanly (exit "
                     f"{rc_b}, stream {streamed}, seconds after SIGTERM "
                     f"{after}, shutdown logged {stopped}):\n"
                     + log_tail(logs["b"]))
            gone = None
            while time.perf_counter() - t_kill < STACK_HEALTH_WINDOW_S:
                urls = [e["url"] for e in json.loads(
                    http(rport, "/engines")[1])["engines"]]
                if f"http://127.0.0.1:{pb}" not in urls:
                    gone = time.perf_counter() - t_kill
                    break
                time.sleep(0.1)
            if gone is None:
                stop_load = True
                fail("stack phase health: the router still lists the "
                     f"stopped engine after {STACK_HEALTH_WINDOW_S}s")
            n_window = len(statuses)
            dead_before = router_served(rport).get(pb, 0.0)
            a_before = served_counts([pa_])[0]
            while len(statuses) < n_window + 16:
                time.sleep(0.05)
            stop_load = True
            for j in jobs:
                j.result()
        n_after = len(statuses) - n_window
        dead_after = router_served(rport).get(pb, 0.0)
        a_after = settle_counts([pa_], [a_before], n_after)[0]
        stop_server(proc)
        routers.remove(proc)
        errors = [s for s in statuses if s != 200]
        print(f"stack phase health: {len(statuses)} requests, engine b "
              f"SIGTERMed after 8, out of discovery {gone:.2f}s later; "
              f"{n_after} requests after that window, the survivor "
              f"served {a_after:.0f}, the stopped engine "
              f"{dead_after - dead_before:.0f}; client errors "
              f"{errors}", flush=True)
        if errors:
            fail(f"stack phase health: clients saw {errors}")
        if dead_after != dead_before or a_after < n_after:
            fail("stack phase health: requests after the detection window "
                 "did not all go to the survivor")
        print(f"stack phase: kernel launches a engine {counts}; "
              f"{time.perf_counter() - t_phase:.1f}s", flush=True)
        return counts
    finally:
        for proc in routers:
            stop_server(proc)
        for proc in reversed(procs):  # decode before its prefill peer
            stop_server(proc)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (REPO / "production_stack_tpu_torch").is_dir():
        fail(f"no production_stack_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from production_stack_tpu_torch.ops import cuda_build
    from production_stack_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    lib = cuda_build.build()
    cuda_build.load()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f}s (one "
          "nvcc per source, in parallel, and one link)", flush=True)
    for line in ptxas_report(lib.with_suffix(".log").read_text()):
        print(f"  ptxas {line}", flush=True)

    secs: dict[str, float] = {}

    def timed(name: str, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            secs[name] = round(time.perf_counter() - t, 1)

    stats = timed("kernel", kernel_phase, torch)
    for model, shape in GEMMA_KERNEL_SHAPES.items():
        timed(f"kernel {model}", kernel_phase, torch, model, shape)
    timed("tp kernel shapes", tp_kernel_shapes, torch)
    timed("forward", forward_phase, torch)
    family_counts = timed("families", families_phase, torch, pa, smi)
    serve_counts, api_counts = timed("serve", serve_phase, torch, smi)
    decode_counts, gap_tol = timed("decode", decode_phase, torch, pa)
    guided_counts = timed("guided", guided_phase, torch, pa, gap_tol, smi)
    timed("pipeline", pipeline_phase, torch, pa, smi)
    mixed_counts = timed("mixed", mixed_phase, torch, pa, gap_tol, smi)
    composed_counts = timed("impl", impl_phase, torch, pa, gap_tol, smi)
    compiled_counts, params, graphed = timed(
        "compiled", compiled_phase, torch, pa, gap_tol, smi)
    sync_counts = timed("sync", sync_phase, torch, pa, smi, params, graphed)
    del params, graphed
    async_counts = timed("async", async_phase, torch, pa, smi)
    # the spec, KV and stack phases serve the 3B cut to CKPT_LAYERS
    with cut_3b_checkpoint(torch, CKPT_LAYERS, "cut-") as cut_dir:
        spec_counts = timed("spec", spec_phase, torch, pa, gap_tol, smi,
                            cut_dir)
        lora_counts = timed("checkpoint", checkpoint_phase, torch, pa,
                            gap_tol, smi)
        kv_counts = timed("kv", kv_phase, torch, pa, gap_tol, smi, cut_dir)
        stack_counts = timed("stack", stack_phase, torch, gap_tol, smi,
                             cut_dir)
    timed("phi-3", phi3_serve_phase, torch, pa, smi)
    gemma_counts = timed("gemma", gemma_serve_phase, torch, pa, gap_tol, smi)
    moe_counts = timed("moe", moe_phase, torch, pa, gap_tol, smi)
    tp_counts = timed("tp", tp_phase, torch, pa, gap_tol, smi)
    lc_counts, lc_first = timed("long-context", long_context_phase, torch,
                                pa, gap_tol, smi)
    timed("pp", pp_phase, torch, pa, gap_tol, smi)
    with cut_3b_checkpoint(torch, TP_LAYERS, "mh-") as mh_dir:
        mh_counts = timed("multi-host", multihost_phase, torch, gap_tol,
                          smi, mh_dir)
    rs_counts = timed("rank-set", rank_set_phase, torch, pa, gap_tol, smi)
    rss_counts = timed("rank-set serving", rank_set_serving_phase, torch,
                       pa, gap_tol, smi, lc_first)
    print(f"phase seconds (host clock, the build apart): {secs}",
          flush=True)
    # the 3B's serve and decode paths, the sync census's engines, and
    # the head_dim-256 paths: the Gemma-7B and Gemma-2B engines of the
    # families phase and the Gemma-7B server
    launches = {
        "ragged": (serve_counts["ragged"] + family_counts["ragged"]
                   + gemma_counts["ragged"] + sync_counts["ragged"]),
        "prefill": (serve_counts["prefill"] + family_counts["prefill"]
                    + gemma_counts["prefill"] + sync_counts["prefill"]),
        "decode": (decode_counts["decode"] + family_counts["decode"]
                   + sync_counts["decode"]),
    }
    print(f"launches: serve path {serve_counts}, API requests "
          f"{api_counts}, decode path {decode_counts}, guided K=8 engine "
          f"{guided_counts}, mixed-round path {mixed_counts}, composed "
          f"ragged rounds {composed_counts}, graphed engines "
          f"{compiled_counts}, sync census engines {sync_counts}, "
          f"async decode {async_counts}, spec "
          f"decode {spec_counts}, loaded "
          f"checkpoint with adapters {lora_counts}, KV paths {kv_counts}, "
          f"Mixtral-8x7B x{MIXTRAL_LAYERS} {moe_counts}, tp=2 ranks "
          f"{tp_counts}, long-context lane engine {lc_counts}, multi-host "
          f"rank 0 {mh_counts}, rank-set features {rs_counts}, "
          f"rank-set async decode and ring {rss_counts}, "
          f"engines behind the router {stack_counts}, "
          f"Gemma-7B and Gemma-2B x{FAMILY_LAYERS} engines "
          f"{family_counts}, Gemma-7B server {gemma_counts}, "
          f"pipeline-parallel ranks none (the gather path); "
          f"a served "
          f"mixed round launches the ragged kernel {LAYERS_3B} times a "
          "forward (its step-0 forward and each further decode iteration)",
          flush=True)
    src = {"ragged": "production_stack_tpu_torch/csrc/paged_attention.cu",
           "prefill": "production_stack_tpu_torch/csrc/paged_prefill.cu",
           "decode": "production_stack_tpu_torch/csrc/paged_decode.cu"}
    replaces = {
        "ragged": "production_stack_tpu/ops/pallas_attention.py:500",
        "prefill": "production_stack_tpu/ops/pallas_attention.py:641",
        "decode": "production_stack_tpu/ops/pallas_attention.py:816",
    }
    names = {"ragged": "ragged_paged_attention",
             "prefill": "paged_prefill_attention",
             "decode": "paged_decode_attention"}
    kernels = []
    for kind, st in stats:
        kernels.append({
            "name": names[kind], "route": "cuda", "source": src[kind],
            "replaces": replaces[kind], "launches": launches[kind], **st,
        })
    zero = [k["name"] for k in kernels if k["launches"] < 1]
    print(json.dumps({"kernels": kernels}), flush=True)
    if zero:
        fail(f"kernels never launched on the main paths: {zero}")
    print(f"total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
