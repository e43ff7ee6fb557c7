#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phase 0  require a CUDA device (exit 2 without one) and print the card's
         name and power limit as ``nvidia-smi`` gives them.
Phase 1  build every CUDA kernel from ``bigdl_tpu_torch/csrc`` (one
         ``nvcc`` per source, all in parallel) and print the seconds and
         what ``ptxas -v`` says of each kernel (registers, stack, spills,
         warnings); every instance of the tensor-core main loop and of
         the GEMV must build with no spill, and the tensor-core main loop
         with no C7520 / C7514 serialisation warning.
Phase 2  hold each kernel against its plain PyTorch version on the card
         at the Llama-2-7B shapes of the served path (q4_0 linears at the
         prefill buckets 16..512 and at decode batch 8) and the Mistral-7B
         shapes of ``generate`` (q4_0 linears at decode batch 4 and
         prefill 4 x 512; stats decode at lengths 512..575 and 4199,
         the 7B linears at M = 4, a verify chunk's),
         plus GQA (Hq 32, Hkv 8), D=64, sliding-window and split-boundary
         shapes, the three dequant-matmuls at the BERT-base shapes (and
         q4_0 at N = 2, 3, 770; q8_0 also with the per-channel stride-0
         scale of ``quantize_model``, bit-equal to the materialised one),
         and kernel 6 (normalised paged decode) at Mistral decode, one
         4233-token Mistral row and Llama-2-7B MHA; kernels 2 and 6 also at
         GLM-4-9B's decode (Hq 32 / Hkv 2, a group of 16) and StarCoder-15B's
         (MQA, a group of 48); kernel 3 at the 7B, Mistral (window 4096),
         GLM-4-9B and D = 96 shapes and at the 7B verify chunks (2, 4
         and 8 rows at offsets 17..1001) on both routes (``ragged_route``:
         ``ragged_prefill_attention_tc`` for bf16, held to 2^-8 max|V| of
         both plain versions, the CUDA-core kernel at 1e-3) and once with
         f32 pools; phase 3e's shapes (q4_0 at the 7B prefill bucket
         2048, kernel 3 at a 1,324-token prefill, a 33-token tail behind
         a fetched 1,024-token prefix and a one-token suffix at 1280,
         kernel 2 behind a 1,024-token prefix); phase 10's shapes, drawn
         after every other case (``family_cases``): q4_0 at
         StarCoder-15B's linears (its multi-query k/v at N = 128 on both
         routes) and GPT-NeoX-20B's fc_out at M = 8 and 512, kernel 2 at
         their served steps (g = 48; D = 96) and StarCoder's generate
         step, kernel 3 at their prefills, a cached StarCoder suffix and
         verify chunk and a NeoX suffix behind 1,024 tokens, then q4_0
         at the ``generate`` paths' linears: StarCoder's at M = 1 and
         Bloom-7b1's at M = 4 and 2048; inputs from a seeded
         ``torch.Generator`` on the card.
         Every dequant-matmul row names the kernel its route takes
         (``<wrapper>_tc`` for M >= TC_MIN_M and N % 16 == 0, else
         ``<wrapper>_gemv``, the split-K GEMV); at the q4_0 buckets and
         the BERT M = 1024 rows both kernels are held and timed
         (``ms_tc``, ``ms_gemv``), every tensor-core row at its three
         block tiles (``ms_by_tile``, the tiles' outputs bit-equal),
         every 7B and Mistral decode row at the GEMV's K-slice counts
         4..32 (``ms_by_slices``), the decode rows also at M = 1 and 2,
         and the paged main-path shapes at split sizes 128, 256 and 512
         (``ms_by_split``). A route sweep holds and times both routes at
         M = 1..64 on the 7B and Mistral decode shapes (how TC_MIN_M was
         set). One JSON line per case with the errors,
         the tolerance, the kernel's / plain version's / one PyTorch
         library call's time (CUDA events, median of 25 calls run back to
         back after warm-up) and the bound (bytes over 3.35 TB/s or FLOPs
         over 989 TFLOP/s, whichever is larger).
Phase 3  the served path on the card against the port's plain path on
         the CPU on a small input (7B width, 2 layers): prefill and decode
         logits within 2e-2 of their largest magnitude. Then build
         Llama-2-7B at full width and depth with synthetic q4_0
         weights made on the card, serve 8 greedy requests (prompts of
         17..300 tokens, 32 new tokens each) through ``LLMServer``
         (max_batch 8, max_seq_len 512, page 16) at the default
         ``pipeline_depth`` 2, every measured decode step a replay of the
         server's captured CUDA graph; check every request got 32
         in-vocab tokens, that the launch counters (zeroed just before;
         a replay adds what its capture launched) are exactly what the
         path must launch (each prompt's prefill on the q4_0 route of its
         bucket, its attention on the tensor cores), that the same
         requests served at ``pipeline_depth=1`` give the same tokens
         with exact counts, and that one request served again alone on a
         fresh server gives the same tokens. Prints TTFT, decode tok/s,
         the host's dispatch and drain-wait time a step, the graph's
         capture seconds and pool bytes, and peak device memory at both
         depths. Then that request on a server with an f32 KV cache (the
         CUDA-core ragged kernel), with exact launch counts. The
         card-vs-CPU check runs at GLM-4-9B width too (2 layers, g = 16).
Phase 3b the served engine's prefix cache and mixed dispatch on phase 3's
         model (max_batch 8, max_seq_len 2048, page 16). (a) 8 greedy
         requests sharing a 1,024-token prefix (64 pages) before phase
         3's tails of 17..300 tokens, 32 new each, with ``kvcache=True``
         and off: 7 hits reusing 1,024 tokens each, every request's
         first-token logits within 2e-2 of the cache-off engine's, exact
         launch counts (each cached prefill at its tail's bucket), TTFT
         and decode tok/s both ways. (b) 7 requests of 17..300 tokens
         decoding 64 new each when an uncached 1,536-token prompt
         arrives, with ``mixed=True`` (``chunk_tokens`` 64: 24 chunks,
         each fused with the decode rows into one mixed pass) and
         ``mixed=False``: the 7 rows' tokens identical, the long
         request's first-token logits within 2e-2, one capture of the
         bucket-64 mixed graph and every later mixed pass a replay,
         exact launch counts; the long request's TTFT, the rows' decode
         tok/s over its admission window and their longest gap between
         tokens, both ways. Then one mixed pass (batch 8 + the last
         64-token chunk at offset 1472) eager and as one CUDA graph, bit
         for bit over 4 passes, traced as in phase 4: 2 dispatch host
         calls (the operand copy and the graph launch) and the token
         fetch.
Phase 3c the served engine's self-speculative decoding and priority
         classes on phase 3's model (max_batch 8, max_seq_len 512, page
         16, depth 2). (a) One request whose prompt is a seeded 24-token
         pattern tiled to 288 tokens, 128 new, ``spec_k`` 8, served alone
         and beside phase 3's first 7 prompts, with ``spec=True`` and
         ``spec=False`` (each workload served twice on its server, the
         first run a warm-up): the pattern row's and the aggregate tok/s,
         verify passes by draft bucket, drafts proposed / accepted /
         emitted and the acceptance rate, how far the spec row's tokens
         equal spec-off's; checks drafts accepted, every pass emitting
         g0 plus its accepted drafts, in-vocab tokens, one capture a
         bucket and every later verify pass a replay, and exact launch
         counts (a verify pass of bucket W: the decode leg, plus 129
         linears at M = W on the GEMV and 32 kernel 3 on the tensor
         cores). (b) Phase 3's 8 prompts as batch requests, 128 new each,
         driven inline; after 16 passes an interactive request of 300
         tokens (32 new), with ``priority=True, kvcache=True`` and with
         ``priority=False``: its TTFT, the preemption and resume counts,
         the tokens the resume reused, the victim's longest gap; the
         victim's tokens before its preemption equal to its tokens
         without priority, exact launch counts. Then one verify pass
         (batch 8, 7 drafts at bucket 8) eager and as one CUDA graph, bit
         for bit over 4 passes, traced as in phase 4.
Phase 3e the host KV tier on phase 3's model (max_batch 8, max_seq_len
         2048, page 16, ``kvcache=True``, a pool of 200 pages: about two
         of the four chains beside the live row). Four distinct
         1,024-token prefixes; pass 1 sends each with a tail of 17..300
         tokens, pass 2 with a new tail (33..257), 32 new tokens each, one
         request at a time, driven inline, with ``kvtier=False`` and with
         ``kvtier=True, host_pages=512`` (4 GiB page-locked): pass 2's
         TTFT, tokens reused, spills, fetches, the mean fetch wait and
         its MB/s, the arena's pinned MB, peak memory; checks fetches > 0
         with none failed, the ledger whole, exact launch counts (each
         prefill at its uncached suffix's bucket) and pass 2's
         first-token logits within 2e-2 of the tier-off run's (leading
         equal tokens reported). Then the last pass-2 chain exported and
         imported into a second server, which admits the prompt from its
         arena: its first-token logits against the exporter's own
         re-admission (both prefill the last token over the same page
         bytes), the blob's MB, export and import ms. Then phase 3c's
         priority scenario with ``kvtier=True``: the victim's chain
         parked "exported", its tokens equal to phase 3c's.
Phase 3d the slot-static engine (``LLMServer(paged=False)``: a dense
         512-token window a slot) on phase 3's model and 8 prompts at
         depths 2 and 1: the broadcast prefill (8 x T rows), exact launch
         counts (no attention kernel), the same tokens at both depths,
         where they part from phase 3's paged tokens, TTFT, tok/s, ms a
         step and peak memory beside phase 3's; then its decode step
         eager and as one CUDA graph, bit for bit over 4 steps, traced.
Phase 4  trace one 7B batch-8 decode step with ``torch.profiler``:
         step wall time, device busy time and idle share, kernel
         launches and the host's launch calls per step, the kernels that
         take the time; first the eager step, then the engine's step as
         one captured CUDA graph, held bit for bit against the eager step
         over 4 steps (tokens, logits, lengths, pools) and traced alike.
         A ``host`` line then sets eager step, graphed step, depth 1 and
         depth 2 side by side.
Phase 5  BERT-base (full width, 12 layers, random weights from a seed)
         through nano's ``InferenceOptimizer``: ``trace`` (float, the
         yardstick), ``quantize`` to int8 / asym_int4 / sym_int4 and
         ``nn.quantized.quantize_model``, batch 8 x 128: exactly 74
         launches of the pipeline's matmul wrapper per forward (0 of the
         others), its 72 M=1024 linears on the tensor cores, ms
         per forward, sequences/s, peak memory, and the card's log-probs
         against the same model's plain path on the CPU
         (batch 2 x 128). Then one int8 forward traced as in phase 4.
Phase 6  bigdl-llm's ``generate()`` on Mistral-7B q4_0 (full width, 32
         layers, weights from a seed made and quantized on the card
         through ``AutoModelForCausalLM.from_pretrained``): (a) batch 4 x
         512 prompts, 64 new tokens, paged decode, then dense decode
         (first-step logits against the paged step within 2e-2; leading
         equal tokens reported); (b) batch 1 x 4200 prompt, 32 new
         tokens (blockwise prefill, the 4096 window bites). Each run with
         exact launch counts (4·L·(1+n) int4_matmul, the prefill's 4·L
         of them on the tensor cores, L·n stats kernels, 0 others),
         in-vocab tokens, prefill s, decode tok/s, peak memory. On (b)'s
         prefill pools, kernel 6 on every layer against stats + merge of
         the last token and against its plain version.
         ``generate``'s paged loop runs its step as one CUDA graph
         (``PagedDecodeLoop``) from the second token on. Then one decode
         step of (a) traced as in phase 4, eager and as the loop's graph.
Phase 7  a 2-layer full-width Mistral safetensors checkpoint (bf16, ~1.4
         GB, written here) loaded by ``from_pretrained(dir,
         load_in_4bit=True)`` on the card and on the CPU: prefill logits
         within 2e-2, 8 greedy tokens each.
Phase 8  GLM-4-9B q4_0 (full width, 40 layers, 32 query heads on 2 KV
         heads; weights from a seed made and quantized on the card by
         ``from_pretrained``): ``generate`` on 2 x 1024 prompts, 32 new
         tokens, paged then dense decode (first-step logits within 2e-2),
         exact launch counts; then ``LLMServer`` on 4 greedy requests of
         100..1000 tokens, 16 new each (max_batch 4, page 16): exact
         launch counts (the prefill attention on the tensor cores), in-vocab
         tokens, one request alone on a fresh server equal to its batched
         tokens, TTFT and decode tok/s, at depth 2 and at depth 1 (the
         same tokens). One paged decode step of the ``generate`` batch
         traced as in phase 4, eager and as the loop's graph.
Phase 9  Mixtral-8x7B (bf16, every width as published, 16 of 32 layers:
         ~47 GB; weights drawn on the card one expert at a time by
         ``from_pretrained(LlamaConfig.mixtral_8x7b())``): a 2-layer
         cut on the card against the CPU's plain path at capacity 1.25
         and 0.0 (prefill and decode logits within 2e-2); ``generate``
         4 x 512, 32 new, paged and dense; ``LLMServer`` on phase 3's 8
         prompts at 1.25 and 0.0, depths 2 and 1, exact launch counts;
         short inline runs with the prefix cache + mixed dispatch,
         speculation and priority, each capturing its graphs; the
         graphed decode step bit for bit against the eager one at both
         factors, no copy of an expert weight in its trace, one layer's
         ``_moe_ffn`` and expert products timed against their byte
         bound, and the graphed step profiled.
Phase 10 the GPT-NeoX, StarCoder and Bloom families, random q4_0 weights
         drawn and quantized on the card a layer at a time from a seed
         (``from_config(load_in_low_bit="sym_int4")``; bf16 heads): each
         cut to 2 layers at full width on the card against the CPU's
         plain path (its own ragged prefill and paged decode step;
         Bloom's dense ``forward``), logits within 2e-2; StarCoder-15B
         (40 layers): ``generate`` 1 x 512 + 32 on the paged loop, phase
         3's 8 prompts served at depth 2 (exact launches a run and a
         step: 6 q4_0 linears and one kernel 2 a layer), the graphed
         step bit-equal to the eager one and profiled, and short runs
         with the prefix cache + mixed dispatch, speculation and
         priority; GPT-NeoX-20B (44 layers): the same served run and
         phase 3b (a)'s prefix-cache run; Bloom-7b1 (30 layers):
         ``generate`` 4 x 512 + 32, dense (kernel 1 only), and
         ``LLMServer`` refusing it.
Phase 11 (after phase 3d, on phase 3's model) the HTTP surface: an
         ``LLMWorker(api=True, tokenizer=ByteTokenizer())`` on
         127.0.0.1 over ``LLMServer(slo=True, watchdog_timeout=5,
         max_queue=16)`` (phase 3's engine settings), every bucket warmed
         inline before ``start()`` arms the watchdog. (a) phase 3's 8
         prompts as 8 concurrent ``POST /worker_generate``: ids equal to
         phase 3's; (b) the same streamed: joined ids equal, time to the
         first chunk beside the engine's ``bigdl_llm_ttft_seconds``,
         aggregate tok/s beside phase 3's; (c) ``/v1/completions`` (token
         prompts) and ``/v1/chat/completions``, plain and SSE: ids equal
         to the engine's, the text's ASCII characters those of
         ``ByteTokenizer.decode`` of the ids, exact ``usage``; (d) the
         ``/metrics`` deltas of decode tokens, finished requests and the
         TTFT sketch's count equal to what was served; (f) a
         ``worker.stall`` delay of twice the timeout under 2 streams:
         ``/healthz`` 503 "stalled" within the timeout + 1 s, both
         streams' terminal chunks ``retriable``, one trip, 200 again
         after, the same ids again; (g) a full queue: 503 with
         Retry-After; (e) phase 3's served run 3 times each with
         observability off and on (flight recorder on), alternating, and
         a window of graphed passes traced both ways (2 host calls a
         pass, the same kernels); (h) a prefill and a decode worker over
         host-tier engines: ``/worker_prefill``, ``/worker_import_chain``,
         ``/worker_generate``, the ids equal to the exporter's own
         re-admission over the same page bytes, the blob's MB and each
         leg's ms. Report key ``serve_http``.
Phase 12 (after phase 11, on phase 3's model) ``LLMRouter`` over two
         ``LLMWorker(role="decode", federation=True)`` on two engines
         that share the weights (phase 3's settings, ``slo=True``,
         ``watchdog_timeout=5``, flight recorder on), every bucket warmed
         inline before ``start()``. (a) blocking round-robin: phase 3's 8
         prompts concurrently, ids equal to phase 3's, both engines
         serving, exact launch counts (zeroed after the warm-up, read
         once both engines are idle: each prompt's prefill at its bucket
         and both engines' decode steps), end-to-end ms and engine TTFT
         beside phase 11's direct figures; (b) ``failover=True``: the
         same ids and exact launch counts, then one stream
         cut mid-generation (``shutdown`` of the worker's accepted
         socket): the tokens before the cut equal the unfailed run's, the
         resumed suffix equals the surviving engine's own answer to
         ``prompt + tokens so far``, ``bigdl_router_failovers_total`` +1,
         the cut engine's pages back, the ms from the cut to the next
         token; (c) a ``worker.stall`` of twice the watchdog on engine 1
         under 2 streams, engine 2 joined by ``POST /backends``: the
         prober marks engine 1, both streams finish on engine 2 with no
         error, engine 1 healthy again, the client-visible stall; (d)
         ``hedge=True`` at budget 1.0 and a 1 ms delay: (a)'s ids, the
         hedges by outcome, every page back; (g) ``api=True``:
         ``/v1/completions`` gives (a)'s ids with exact ``usage``; (h)
         each worker's ``/metrics/snapshot`` roofline names
         ``llm/decode_paged`` with (a)'s steps, ``bigdl_device_bw_util``
         in (0, 1.05] after (a), and over phase 3's run on one engine
         within 25% of phase 3's bytes a step, reckoned from the 7B
         shapes (``SEVEN_B_LINEARS``' q4_0 planes and the K/V at the
         rows' lengths), over its step ms over 3.35 TB/s; the host cost
         of one ``utilization.observe`` over a full window; one capture
         record per decode graph built; (e)
         the two-stage route over host-tier engines: the ids equal the
         exporter's re-admission, each leg's ms; (f) ``federation=True``:
         the merged decode-token count equal to the members' sum,
         ``/fleet/status`` naming both workers, a stopped worker stale
         within 2 scrape intervals. Report key ``router``.
Phase 13 (after phase 12, on phase 3's model) the time-series plane,
         alerts, the elastic fleet, the converter, the CLI and LangChain.
         (a) phase 3's served run 3 times each with the plane off and
         on (0.25 s sampler), alternating: tok/s, step and dispatch ms;
         a window of graphed passes traced with the plane off and on
         (a 10 ms sampler): 2 host calls and phase 11's kernels a pass;
         one ``sample_now`` over the live registry (median of 25);
         ``/metrics/query`` p99 of ``bigdl_llm_ttft_seconds`` equal to
         ``sketch_window`` over the engine's own sketch snapshots taken
         at the window's two samples, and the decode-token delta equal
         to the tokens served; (b) one ``burn_rate`` rule on ttft (short
         2 s, long 4 s, factor 2, objective 0.99; ``bigdl.slo.ttft_ms``
         3x phase 3's mean TTFT) over an engine behind ``LLMWorker``:
         sparse clean traffic keeps it inactive, a storm of ``llm.step``
         delays (1.2x the target + 50 ms a pass) fires it on the first
         sample that holds a violation, clean traffic resolves it; the
         transitions equal the flight events, the
         ``bigdl_alerts_transitions_total`` deltas and ``/alerts``; (c)
         ``LLMRouter(failover, federation, fleet)`` over a
         ``LocalWorkerProvider`` of phase 3's engines (host tier on,
         every bucket warmed inline at launch), the controller ticked
         from the harness at its interval: 32 requests scale it out
         (pressured tick to join, split into build, warm-up with
         capture, and join), a prompt only the new engine holds, the
         idle pool scales in (``draining`` → ``migrating`` →
         ``drained``: chains, pages, MB, ms), the survivor reuses the
         migrated prefix and answers as the drained engine did, no
         request lost, one engine left, exact kernels ran; (d)
         ``save_model`` of the 7B into a temporary directory (free disk
         first), ``load_model`` bit for bit (ids and last logits)
         against the source with its q4_0 scales rounded to bf16 (the
         format's rule), ``cli.main`` (its tok/s), ``BigdlTpuLLM`` equal
         to the CLI, ``BigdlTpuOpenAI`` over an ``LLMWorker(api=True)``
         equal to that engine's answer. Report key ``fleet``.

Phase 14 every bigdl-llm low-bit format, the native quantizer and the
         operator tools. (a) after phase 5: BERT-base (phase 5's model
         and weights) through nano ``quantize`` at sym_int5 / nf4 / fp4
         / fp8 and ``optimize_model`` at bf16, beside sym_int4: ms a
         forward (batch 8 x 128), no kernel launched (the formats
         dequantize in plain PyTorch, as the JAX package's do outside
         Pallas), the card's log-probs against the same quantized
         model's CPU forward within 2e-2 of their largest magnitude;
         ``LowBitLinear`` of every format at the 7B qkv / o / gate_up /
         down shapes, M = 8 (quantize ms, forward ms beside the sym_int4
         GEMV; figures); the native quantizer built with ``g++`` here
         and bit-equal to the numpy path at 4096 x 4096 (times, the host
         CPU), ``quantize_torch`` on the card at every format and
         ``quantize_model``'s per-channel int8 bit-equal to the host's.
         Report key ``formats``. (b) after phase 13 on phase 3's model:
         ``run_load`` of 64 seeded prompts (a 16-token shared prefix, 8
         new tokens, 32 qps, 8 clients) through an ``LLMWorker`` native
         and through the gateway's SSE: none lost, each index the
         engine's answer to that prompt alone, client p50 / p99, launch
         counts exactly ``_path_expect``; 16 of them through a federated
         router over two engines (exact launches) read back by
         ``fleet_report --url`` (merged counters equal the members'
         sums); ``run_fleet_soak(model=...)`` (none lost, a scale-out and
         a scale-in); ``run_alerts_chaos`` and ``run_fleet_chaos`` (held
         to the engine's answers alone) in smoke mode at 7B, each
         passing its own contract. Report key ``tools``.

Phase 15 DLlib training, last, after phase 10 (report key ``dllib``):
         (a) LeNet-5 on ``load_mnist()``'s synthetic digits through the
         port's ``LocalOptimizer`` (Adam 0.003, batch 128, 6 epochs, Top1
         validation and a checkpoint every epoch): top-1 above 0.9, and a
         run stopped after epoch 3 and auto-resumed by a fresh model and
         optimizer within 1e-3 of each tensor's largest weight of the
         uninterrupted run (cuDNN and max-pool backward are not bitwise
         deterministic); (b) ResNet-50 NHWC at 224 x 224, batch 256,
         bf16 inputs, SGD 0.1 / 0.9 / 1e-4: 3 warm-up and 20 timed steps
         (CUDA events at dispatch: ms a step, images/s), peak memory, a
         3-step profiler window (device busy and idle share, launches a
         step), the port's launch counters 0 (no custom kernel on this
         path); (c) ResNet-50 f32 at batch 2, one step on the card and on
         the CPU from the same weights (TF32 off): the loss, the BN
         statistics, each parameter within its update and the update's
         L2 deviation beside the CPU's own across thread counts; NHWC
         and NCHW give one loss.

Phase 16 the DLlib graph and Keras API, after phase 15 (report key
         ``dllib_keras``): (a) Inception-v1 (``inception_v1(1000)``) at
         224 x 224, batch 256, bf16 inputs, the reference's SGD recipe:
         3 warm-up and 20 timed steps, a 3-step profiler window, peak
         memory; 4 steps fed by the port's own pipeline (synthetic
         256 x 256 images, ``RandomCrop`` and ``HFlip``, the
         prefetcher), the host data wait beside the compute; one f32
         step at batch 2 on the card against the CPU; (b) the Keras
         API: ``examples/lenet_mnist.py``'s model through
         ``keras.Sequential`` (top-1 >= 0.99), then a functional
         ``keras.Model`` of the GoogLeNet trunk (no LRN) at 224 x 224,
         batch 64, its loss falling; (c) the PTB "medium" LSTM language
         model (2 x 650, 35 steps, batch 20, vocabulary 10,000): 3
         warm-up and 10 timed steps, a 2-step profiler window, one f32
         step at batch 2 on the card against the CPU. Each sub-phase
         checks that the port's launch counters stay 0.

Phase 17 data-parallel DLlib training over ``torch.distributed``, after
         phase 16 (report key ``dllib_distributed``): (a) phase 16 (b)'s
         Keras LeNet-5 through ``fit`` with its defaults, which trains
         through ``DistriOptimizer`` on the Engine's NCCL world of one
         (top-1 >= 0.99); (b) ResNet-50 NHWC, 224 x 224, batch 256, bf16
         inputs, phase 15 (b)'s SGD, through ``DistriOptimizer`` in
         gradient-compression modes None, bf16 and int8, between two
         ``LocalOptimizer`` runs (the base): 3 warm-up and 10 timed
         steps each (CUDA events at dispatch), and the three gradient
         all-reduces alone on ResNet-50's gradients (events as called,
         and behind a spin of the stream: the device's own time); (c)
         one f32 step at batch 2 of a conv + batch-norm net in each
         mode, on the card (NCCL) and on the CPU (a gloo group), the
         loss, the statistics and each parameter within its update;
         (d) ``quantize_model(LeNet5())`` (int8 convolutions and
         linears) and a ``ConvLSTMPeephole`` forward and backward, card
         against CPU. The port's launch counters stay 0
         in (a)-(c) and on the ConvLSTM; (d)'s quantized ``Linear``
         launches the int8 matmul once a forward (fc_1; fc_2's K = 100 is
         not a multiple of 32 and takes the plain product). The process
         group is destroyed before the phase ends.

Phase 18 detection, Mask R-CNN, the sparse layers and three chaos
         drives, after phase 17 (report key ``detection_sparse``): (a)
         Mask R-CNN at ``MaskRCNNConfig()`` (81 classes, 224 x 224, 6.12
         M parameters, f32, random weights from a seed) at batches 1 and
         8: 3 warm-up and 20 timed forwards (CUDA events at dispatch; ms
         a forward, images/s), one profiled forward (device kernels a
         forward, idle share), peak memory, every slot's box inside the
         image, masks in [0, 1], labels in [0, 80], fixed shapes; timed
         under this script's flags (TF32 off) and once more at batch 8
         under torch's defaults (cuDNN TF32 on); (b) batch 2 on the card
         against the CPU from the same seed: the pyramid and RPN logits
         under torch's defaults within ``MRCNN_TF32_TOL`` of each one's
         largest magnitude, then with TF32 off labels and valid slots
         exactly, boxes, scores and masks within ``MRCNN_TOL``; (c)
         ``LookupTableSparse`` (2^20 x 64, ids 4096 x 32, a quarter
         padding, each combiner) and ``SparseLinear`` (2^20 -> 256, 40
         non-zeros a row, batch 4096): forward and forward + backward ms,
         card against CPU (outputs and gradients, ``SPARSE_TOL``); the
         port's launch counters stay 0 in (a)-(c); (d) the ``--chaos``
         (LeNet-5 training), ``--kvcache`` and ``--kvtier`` drives of
         ``llm/chaos.py`` on the card, each passing its contract, their
         fired events and launch counts reported.

Every phase's line has the SM clock and power draw (``nvidia-smi
--query-gpu=clocks.sm,power.draw``) on the line before it. Then a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the run
ends nonzero and prints no result. The full report also goes to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX or ``bigdl_tpu``.
"""

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
REPO = os.path.dirname(os.path.abspath(__file__))


def smi_clocks():
    """The card's SM clock and power draw now, as ``nvidia-smi`` gives
    them (the 7B step runs at one of two speeds: the clock tells which)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line has the SM clock and power draw on
    the line before it, and its seconds since the script started."""
    if "phase" in obj:
        obj["t_s"] = time.perf_counter() - T0
        obj["sm_clock_power"] = smi_clocks()
        print(f"{obj['phase']}: clocks.sm, power.draw = "
              f"{obj['sm_clock_power']}", flush=True)
    print(json.dumps(obj), flush=True)


def bound(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_ms(fn, iters=25, warmup=3):
    """Median device time of one call over ``iters`` calls run back to
    back: a CUDA event after each call, and the card held busy
    (``torch.cuda._sleep``) while the host enqueues them all, so a short
    kernel is timed on the device and not at the rate the host can
    launch it. A call that synchronises inside (the plain versions read
    lengths back) is timed with its host gaps included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    # ~2e9 cycles a second at the H100's boost clock; capped at 2 s
    torch.cuda._sleep(int(min(host_s * iters * 1.5, 2.0) * 2e9))
    evs[0].record()
    for i in range(iters):
        fn()
        evs[i + 1].record()
    evs[-1].synchronize()
    return statistics.median(evs[i].elapsed_time(evs[i + 1])
                             for i in range(iters))


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


# -- phase 1: the build ---------------------------------------------------------

# the tensor-core sources (on csrc/tc_gemm.cuh): ptxas must neither spill
# nor serialise their wgmma (C7520: one under a branch; C7514: an
# accumulator read while one is in flight)
TC_SOURCES = ("int4_matmul_tc", "lowbit_matmul_tc", "ragged_prefill_tc")
# the sources whose every instance must build with no spill
SPILL_FREE = TC_SOURCES + ("lowbit_gemv",)


def _demangle(names):
    import shutil
    if not names or shutil.which("c++filt") is None:
        return {n: n for n in names}
    out = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                         capture_output=True, timeout=60).stdout.split("\n")
    return {n: (d.split(">(")[0] + ">" if ">(" in d else d)
            for n, d in zip(names, out)}


def ptxas_report(log):
    """What ``ptxas -v`` said of each kernel of one build: registers,
    stack frame and spill bytes by (demangled) kernel, and its warnings."""
    import re
    kern, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", line)
        if m:
            cur = m.group(1)
            kern.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            kern[cur].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            kern[cur]["registers"] = int(m.group(1))
    names = _demangle(sorted(kern))
    return {"kernels": {names[k]: v for k, v in kern.items()},
            "warnings": [l.strip() for l in log.splitlines()
                         if "warning" in l.lower()]}


# -- phase 2: kernels against their plain versions ---------------------------

# the linears of BERT-base at batch 8 x 128 (M = 1024 rows), and the pooler
# and classifier, which see one row per sequence; the last field is how
# many of each one forward launches (12 layers)
BERT_SHAPES = (("qkvo", 1024, 768, 768, 48), ("ffn1", 1024, 768, 3072, 12),
               ("ffn2", 1024, 3072, 768, 12), ("pooler", 8, 768, 768, 1),
               ("classifier", 8, 768, 2, 1))


def _planes(torch, dev, gen, kind, k, n):
    """Random weights in the k-major layout of ``kind``'s kernel."""
    s = torch.empty((k // 32, n), device=dev).uniform_(0.001, 0.02,
                                                        generator=gen)
    if kind == "int8_matmul":
        return (torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8), s)
    q = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                      dtype=torch.uint8)
    if kind == "int4_matmul":
        return q, s
    z = torch.empty((k // 32, n), device=dev).uniform_(-0.15, 0.0,
                                                       generator=gen)
    return q, s, z


def _forced_route(torch, kind, route, x, planes, out_dtype, tile=None,
                  slices=None):
    """One call of ``kind``'s wrapper through the named kernel (and
    tensor-core tile or GEMV K slices) whatever the rules say (the
    TC_MIN_M, block-shape and slice sweeps)."""
    from bigdl_tpu_torch.llm import kernels as K
    from bigdl_tpu_torch.llm.kernels import _build
    from bigdl_tpu_torch.llm.kernels.int4_matmul import _group_stride, _launch
    lds = None if kind == "int4_matmul" else _group_stride(kind, planes[1])
    out = torch.empty((x.shape[0], planes[0].shape[1]), dtype=out_dtype,
                      device=x.device)
    _build.check(_launch(getattr(K, kind), x, planes, out, route, lds, tile,
                         slices), f"{kind} {route}")
    return out


TC_TILES = ((128, 128), (64, 128), (64, 64))
GEMV_SLICES = (4, 8, 16, 32)


def matmul_case(torch, dev, gen, kind, what, m, k, n, path_dtype,
                launches=0, per=None, both_routes=False, per_channel=False,
                slices_sweep=False):
    """One dequant-matmul case: the kernel's f32-out and bf16-out entries
    against the plain version on the same bf16 x and planes; the entry
    the path launches (``path_dtype`` out) is the one timed. ``launches``
    is how many calls of this shape the path makes ``per`` step or
    forward (0: a shape no path runs). A row names the kernel the route
    rule takes; with ``both_routes`` both kernels are also held to the
    plain version and timed (``ms_tc``, ``ms_gemv``); with
    ``slices_sweep`` a GEMV row is timed at every K-slice count of
    ``GEMV_SLICES`` (``ms_by_slices``, how ``gemv_slices`` was chosen).
    With ``per_channel`` (q8_0) the scale is one row expanded over the
    groups (stride 0, as ``nn.quantized.Linear`` passes it), and the
    result must equal the materialised scale's bit for bit."""
    from bigdl_tpu_torch.llm import kernels as K
    fn, ref, deq = {
        "int4_matmul": (K.int4_matmul, K.int4_matmul_reference,
                        K.dequant_q4),
        "asym_int4_matmul": (K.asym_int4_matmul,
                             K.asym_int4_matmul_reference, K.dequant_q4_1),
        "int8_matmul": (K.int8_matmul, K.int8_matmul_reference,
                        K.dequant_q8_0)}[kind]
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    planes = _planes(torch, dev, gen, kind, k, n)
    if per_channel:
        planes = (planes[0], planes[1][:1].expand(k // 32, n))
    got = fn(x, *planes, out_dtype=torch.float32)
    want = ref(x, *planes, torch.float32)
    got16 = fn(x, *planes, out_dtype=torch.bfloat16)
    want16 = ref(x, *planes, torch.bfloat16)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    tol = 2e-5 * scale
    err16 = (got16.float() - want16.float()).abs().max().item()
    tol16 = 1e-4 + 2.0 ** -7 * scale
    w16 = deq(*planes, dtype=torch.bfloat16)
    out_bytes = 2 if path_dtype == torch.bfloat16 else 4
    # each input read once: a per-channel scale is its one row
    nbytes = (m * k * 2 + planes[0].numel() * planes[0].element_size()
              + sum(p[:1].numel() * 4 if per_channel else p.numel() * 4
                    for p in planes[1:]) + m * n * out_bytes)
    b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
    route = K.matmul_route(m, n)
    row = {
        "kernel": f"{kind}_{route}",
        "route": route, "case": f"{what} M={m} K={k} N={n}"
        + (" per-channel scale" if per_channel else ""),
        "path_out": str(path_dtype).replace("torch.", ""),
        "max_abs_err": err, "max_rel_err": err / scale, "tol": tol,
        "tol_rule": "f32 out: 2e-5 * max|plain| (f32 sums, another order); "
                    "bf16 out: 1e-4 + 1 bf16 ulp of max|plain| (2^-7 of it)",
        "max_abs_err_bf16out": err16, "tol_bf16out": tol16,
        "ms": time_ms(lambda: fn(x, *planes, out_dtype=path_dtype)),
        "plain_ms": time_ms(lambda: ref(x, *planes, path_dtype)),
        "library_ms": time_ms(lambda: torch.matmul(x, w16)),
        "library": "torch.matmul(x, dequantized bf16 w)",
        "bound_ms": b_ms, "bound_by": b_by,
        "launches": launches, "launches_per": per,
        "passed": err <= tol and err16 <= tol16}
    if per_channel:
        same = torch.equal(fn(x, planes[0], planes[1].contiguous(),
                              out_dtype=torch.float32), got)
        row["equal_to_materialised_scale"] = same
        row["passed"] &= same
    if route == "tc":
        # every tile gives the same bits; each is timed, which is how
        # tc_block_shape was chosen
        row["tile"] = "x".join(map(str, K.tc_block_shape(
            m, n, kind == "asym_int4_matmul")))
        ref_out = _forced_route(torch, kind, "tc", x, planes, torch.float32,
                                TC_TILES[0])
        row["ms_by_tile"] = {}
        for tile in TC_TILES:
            same = torch.equal(_forced_route(
                torch, kind, "tc", x, planes, torch.float32, tile), ref_out)
            row["passed"] &= same
            row["ms_by_tile"]["x".join(map(str, tile))] = time_ms(
                lambda: _forced_route(torch, kind, "tc", x, planes,
                                      path_dtype, tile))
        del ref_out
    if route == "gemv":
        row["slices"] = K.gemv_slices(k, n)
    if route == "gemv" and slices_sweep:
        row["ms_by_slices"] = {
            str(sl): time_ms(lambda: _forced_route(
                torch, kind, "gemv", x, planes, path_dtype, slices=sl))
            for sl in GEMV_SLICES}
    if both_routes:
        for r in ("tc", "gemv"):
            if n % 16 and r == "tc":
                continue
            e = (_forced_route(torch, kind, r, x, planes, torch.float32)
                 - want).abs().max().item()
            row[f"max_abs_err_{r}"] = e
            row["passed"] &= e <= tol
            row[f"ms_{r}"] = time_ms(lambda: _forced_route(
                torch, kind, r, x, planes, path_dtype))
    del x, planes, got, want, got16, want16, w16
    return row


# Mistral-7B's fused linears (K, N): GQA makes qkv N = 4096 + 2 * 1024
MISTRAL_LINEARS = ((4096, 6144, "qkv_proj"), (4096, 4096, "o_proj"),
                   (4096, 28672, "gate_up_proj"), (14336, 4096, "down_proj"))


# Llama-2-7B's fused q4_0 linears and its q4_0 lm_head (K, N, name,
# launches a forward: one a layer, lm_head once)
SEVEN_B_LINEARS = ((4096, 12288, "qkv_proj", 32), (4096, 4096, "o_proj", 32),
                   (4096, 22016, "gate_up_proj", 32),
                   (11008, 4096, "down_proj", 32), (4096, 32000, "lm_head", 1))


# StarCoder-15B's q4_0 linears (K, N, name, launches a forward: 40 layers;
# q and o, k and v share a shape) and GPT-NeoX-20B's fc_out (44 layers)
STARCODER_LINEARS = ((6144, 6144, "StarCoder q_proj / o_proj", 80),
                     (6144, 128, "StarCoder k_proj / v_proj", 80),
                     (6144, 24576, "StarCoder fc_in", 40),
                     (24576, 6144, "StarCoder fc_out", 40),
                     (24576, 6144, "GPT-NeoX-20B fc_out", 44))
# Bloom-7b1's (30 layers; q, k, v and o share a shape)
BLOOM_LINEARS = ((4096, 4096, "Bloom q/k/v/o_proj", 120),
                 (4096, 16384, "Bloom fc_in", 30),
                 (16384, 4096, "Bloom fc_out", 30))


def family_cases(torch, dev, gen):
    """Phase 10's kernel shapes, drawn after every earlier case so those
    keep their inputs: kernel 1 at StarCoder-15B's linears and
    GPT-NeoX-20B's fc_out at the served decode step (8 rows) and at a
    prefill bucket (512), the multi-query k/v (N = 128: one GEMV tile,
    two tensor-core tiles) on both routes; kernel 2 at the two served
    steps and StarCoder's ``generate`` step; kernel 3 at their
    prefills, a cached suffix and a verify chunk; then kernel 1 at the
    ``generate`` paths' shapes: StarCoder's decode step (1 row), and
    Bloom-7b1's decode step (4 rows) and prefill (4 x 512 rows)."""
    out = [matmul_case(torch, dev, gen, "int4_matmul", what, m, k, n,
                       torch.bfloat16, c, f"{what.split()[0]} {per}",
                       both_routes=n == 128,
                       slices_sweep=m == 8 and n == 128)
           for m, per in ((8, "decode step"), (512, "prefill, bucket 512"))
           for k, n, what, c in STARCODER_LINEARS]
    served = [x + 16 for x in LENS_MAIN]
    out += paged_cases(torch, dev, gen, (
        ("StarCoder-15B served decode", 48, 1, 128, None, served),
        ("GPT-NeoX-20B served decode", 64, 64, 96, None, served),
        ("StarCoder-15B generate decode", 48, 1, 128, None, [527])))
    out += ragged_cases(torch, dev, gen, (
        ("StarCoder-15B prefill", 48, 1, 128, 0, 300, 512, None, "bf16"),
        ("GPT-NeoX-20B prefill", 64, 64, 96, 0, 300, 512, None, "bf16"),
        ("StarCoder-15B cached suffix", 48, 1, 128, 128, 47, 64, None,
         "bf16"),
        ("StarCoder-15B verify W=8", 48, 1, 128, 301, 8, 8, None, "bf16"),
        ("GPT-NeoX-20B cached tail", 64, 64, 96, 1024, 300, 512, None,
         "bf16")))
    gen_paths = [(1, "StarCoder generate decode step", STARCODER_LINEARS[:4]),
                 (4, "Bloom generate decode step", BLOOM_LINEARS),
                 (2048, "Bloom generate prefill, 4 x 512", BLOOM_LINEARS)]
    return out + [matmul_case(torch, dev, gen, "int4_matmul", what, m, k, n,
                              torch.bfloat16, c, per)
                  for m, per, linears in gen_paths
                  for k, n, what, c in linears]


def int4_cases(torch, dev, gen):
    """q4_0 at the Llama-2-7B shapes (bf16 out, as served), at the
    Mistral-7B shapes of ``generate`` (bf16 out), at the BERT shapes (f32
    out, as the sym_int4 pipeline runs it) and at N = 3 and 770 (N not a
    multiple of 4)."""
    out = []
    # the served prefill buckets: every request's prompt is padded to a
    # power of two (at least one page); both routes timed (TC_MIN_M)
    for m in (16, 32, 64, 128, 256):
        for k, n, what in ((4096, 12288, "qkv_proj"),
                           (4096, 22016, "gate_up_proj")):
            out.append(matmul_case(torch, dev, gen, "int4_matmul", what, m,
                                   k, n, torch.bfloat16, 32,
                                   f"7B prefill, bucket {m}",
                                   both_routes=True))
    # decode at the served batch (8) and at 1 and 2 rows (no path's
    # count: the served step always runs max_batch rows), a verify chunk
    # of 4 rows (phase 3c), prefill, and the whole prefill of a prompt
    # behind a 1,024-token prefix (phases 3b and 3e: bucket 2048)
    for m, per, count in ((1, None, 0), (2, None, 0),
                          (4, "7B verify chunk, bucket 4", 32),
                          (8, "7B decode step", 32), (512, "7B prefill", 32),
                          (2048, "7B prefill of 1,024 + tail", 32)):
        for k, n, what, c in SEVEN_B_LINEARS:
            c = c if count else 0
            out.append(matmul_case(torch, dev, gen, "int4_matmul", what, m,
                                   k, n, torch.bfloat16, c, per,
                                   both_routes=m < 2048 and what in (
                                       "qkv_proj", "gate_up_proj"),
                                   slices_sweep=m == 8))
    # the slot-static engine's broadcast prefill (phase 3d): a prompt of
    # T tokens runs as max_batch (8) identical rows, every linear and
    # lm_head at M = 8 x T, not a multiple of any tile's M (the shortest,
    # a middle and the longest of phase 3's prompts)
    for t in (17, 139, 300):
        for k, n, what, c in SEVEN_B_LINEARS:
            out.append(matmul_case(torch, dev, gen, "int4_matmul", what,
                                   8 * t, k, n, torch.bfloat16, c,
                                   f"7B slot-static prefill, T = {t}"))
    # Mistral-7B's linears at generate (b)'s decode step (batch 1), (a)'s
    # (batch 4) and (a)'s prefill (4 x 512 rows); lm_head stays dense on
    # that path
    for m, per, count in ((1, "Mistral (b) decode step", 32), (2, None, 0),
                          (4, "Mistral decode step", 32),
                          (2048, "Mistral prefill", 32)):
        for k, n, what in MISTRAL_LINEARS:
            out.append(matmul_case(torch, dev, gen, "int4_matmul",
                                   f"Mistral {what}", m, k, n,
                                   torch.bfloat16, count, per,
                                   both_routes=m > 8 and what == "o_proj",
                                   slices_sweep=m in (1, 4)))
    for what, m, k, n, count in BERT_SHAPES:
        out.append(matmul_case(torch, dev, gen, "int4_matmul",
                               f"BERT {what}", m, k, n, torch.float32, count,
                               "BERT sym_int4 forward"))
    for n in (3, 770):
        out.append(matmul_case(torch, dev, gen, "int4_matmul", "odd N", 8,
                               768, n, torch.float32))
    return out


# the M of the route sweep, and its shapes (7B and Mistral decode)
SWEEP_M = (1, 2, 4, 8, 12, 15, 16, 24, 32, 40, 48, 64)
SWEEP_SHAPES = ((4096, 12288, "7B qkv_proj"), (4096, 4096, "7B o_proj"),
                (4096, 22016, "7B gate_up_proj"), (11008, 4096, "7B down_proj"),
                (4096, 4096, "Mistral o_proj"), (14336, 4096, "Mistral down_proj"))


def route_sweep(torch, dev, gen):
    """Both q4_0 kernels forced at every M of ``SWEEP_M`` on the decode
    shapes: each held to the plain version (f32 out, 2e-5 of max|y|) and
    timed with the path's bf16 out. The least M at which the tensor-core
    GEMM is faster on these shapes is what ``TC_MIN_M`` is set from."""
    from bigdl_tpu_torch.llm import kernels as K
    rows = []
    for k, n, what in SWEEP_SHAPES:
        planes = _planes(torch, dev, gen, "int4_matmul", k, n)
        row = {"case": f"{what} K={k} N={n}", "ms_gemv": {}, "ms_tc": {},
               "route": {}, "passed": True}
        for m in SWEEP_M:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            want = K.int4_matmul_reference(x, *planes, torch.float32)
            tol = 2e-5 * want.abs().max().item()
            for r in ("gemv", "tc"):
                got = _forced_route(torch, "int4_matmul", r, x, planes,
                                    torch.float32)
                row["passed"] &= (got - want).abs().max().item() <= tol
                row[f"ms_{r}"][m] = time_ms(lambda: _forced_route(
                    torch, "int4_matmul", r, x, planes, torch.bfloat16))
            row["route"][m] = K.matmul_route(m, n)
        rows.append(row)
        del planes
    return rows


def lowbit_cases(torch, dev, gen):
    """q4_1 and q8_0 at the BERT-base shapes, f32 out as the pipelines
    run them (the M = 1024 rows on both routes), and q8_0 with the
    per-channel stride-0 scale of ``quantize_model``; then both formats
    on the GEMV at M = 1 and 2 on the 7B qkv and Mistral down shapes (no
    path runs them: the GEMV's q4_1 and q8_0 instances at decode
    sizes)."""
    return [matmul_case(torch, dev, gen, kind, f"BERT {what}", m, k, n,
                        torch.float32, count, f"BERT {pipe} forward",
                        both_routes=m > 8, per_channel=pc)
            for kind, pipe, pc in (("int8_matmul", "int8", False),
                                   ("asym_int4_matmul", "asym_int4", False),
                                   ("int8_matmul", "quantize_model", True))
            for what, m, k, n, count in BERT_SHAPES] + [
        matmul_case(torch, dev, gen, kind, what, m, k, n, torch.bfloat16)
        for kind in ("int8_matmul", "asym_int4_matmul") for m in (1, 2)
        for k, n, what in ((4096, 12288, "7B qkv_proj"),
                           (14336, 4096, "Mistral down_proj"))]


def _gathered(torch, pages, bt, n_tok, g):
    """(P, Hkv, page, D) → (B, Hq, n_tok, D), GQA heads expanded."""
    b = bt.shape[0]
    _, hkv, page, d = pages.shape
    npg = -(-n_tok // page)
    a = pages[bt[:, :npg].long()].permute(0, 2, 1, 3, 4).reshape(
        b, hkv, npg * page, d)[:, :, :n_tok]
    return a.repeat_interleave(g, dim=1)


def _paged_inputs(torch, dev, gen, hq, hkv, d, lens, page=16):
    """bf16 q and pools, a shuffled block table with room for ``lens``,
    int32 lengths, all on the card from ``gen``."""
    B = len(lens)
    maxp = max(32, -(-max(lens) // page) + 1)
    P = 1 + B * maxp
    q = torch.randn((B, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    kp, vp = (torch.randn((P, hkv, page, d), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    bt = (1 + torch.randperm(P - 1, generator=gen, device=dev)[
        :B * maxp]).reshape(B, maxp).to(torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, ln


def _sdpa_yardstick(torch, q, kp, vp, bt, lens, win):
    """``F.scaled_dot_product_attention`` of one query per row over the
    gathered live K/V (GQA heads expanded, window masked), ready to time;
    empty rows are kept finite."""
    import torch.nn.functional as F
    dev = q.device
    smax = max(lens)
    g = q.shape[1] // kp.shape[1]
    kg = _gathered(torch, kp, bt, smax, g)
    vg = _gathered(torch, vp, bt, smax, g)
    pos = torch.arange(smax, device=dev)[None]
    ln = torch.tensor(lens, device=dev)[:, None]
    mask = pos < ln
    if win is not None:
        mask &= pos >= ln - win
    mask[:, 0] |= ~mask.any(dim=1)
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)


LENS_MAIN = [17, 57, 98, 139, 180, 220, 260, 300]
# decode at B = 4 around 1024 tokens (the GLM-4-9B phase's contexts)
GLM_DECODE_LENS = [990, 1023, 1040, 1100]
# lengths on and next to the split boundaries (SPLIT_KEYS = S): S*j +- 1,
# one exactly on a boundary, an empty row and a short one
SPLIT_SWEEP = (128, 256, 512)


def _split_lens(S):
    return [S - 1, S, S + 1, 2 * S - 1, 2 * S + 1, 3 * S + 1, 0, 5]


def paged_cases(torch, dev, gen, shapes=None):
    """Kernel 2 (stats) against its plain version at ``shapes`` (what,
    Hq, Hkv, D, window, lengths; default the phases before 10); the
    main-path shapes are also timed at every split size of
    ``SPLIT_SWEEP`` (``ms_by_split``), which is how SPLIT_KEYS was
    chosen."""
    from bigdl_tpu_torch.llm.kernels.paged_attention import (
        SPLIT_KEYS, _decode_cuda, paged_attention_decode_stats,
        paged_attention_reference_stats)
    page = 16
    out = []
    S = SPLIT_KEYS
    for what, hq, hkv, d, win, lens in shapes or (
            ("split boundaries", 32, 8, 128, None, _split_lens(S)),
            ("split boundaries window=300", 32, 8, 128, 300, _split_lens(S)),
            ("7B decode", 32, 32, 128, None, LENS_MAIN),
            # rows behind a 1,024-token prefix (phases 3b and 3e), one idle
            ("7B decode after 1,024 tokens", 32, 32, 128, None,
             [PREFIX_TOKENS + x for x in LENS_MAIN[:7]] + [0]),
            ("GQA Hkv=8", 32, 8, 128, None, [0] + LENS_MAIN[1:]),
            ("D=64", 32, 32, 64, None, LENS_MAIN),
            ("GQA window=100", 32, 8, 128, 100, LENS_MAIN),
            # generate (a)'s decode, lengths excluding the current token
            # and the window shrunk by one, as paged_attend calls it
            ("Mistral decode", 32, 8, 128, 4095, [512, 533, 554, 575]),
            ("Mistral long", 32, 8, 128, 4095, [4199]),
            # Mixtral's served step (phase 9 (b): 8 rows, no window, phase
            # 3's prompts 16 tokens in) and its generate (a) step (4 rows
            # of 512-token prompts, 15 tokens in)
            ("Mixtral served decode", 32, 8, 128, None,
             [x + 16 for x in LENS_MAIN]),
            ("Mixtral generate decode", 32, 8, 128, None, [527] * 4),
            # a group of 16 (GLM-4-9B) and of 48 (StarCoder-15B's MQA)
            ("GLM-4-9B decode", 32, 2, 128, None, GLM_DECODE_LENS),
            ("StarCoder-15B decode", 48, 1, 128, None, GLM_DECODE_LENS)):
        q, kp, vp, bt, ln = _paged_inputs(torch, dev, gen, hq, hkv, d, lens)
        B = len(lens)
        acc, m, l = paged_attention_decode_stats(q, kp, vp, bt, ln, page,
                                                 sliding_window=win)
        racc, rm, rl = paged_attention_reference_stats(
            q, kp, vp, bt, ln, sliding_window=win)
        torch.cuda.synchronize()
        live = ln > 0
        o, ro = (acc[live] / l[live][..., None],
                 racc[live] / rl[live][..., None])
        err = (o - ro).abs().max().item()
        err_m = (m - rm).abs().max().item()
        err_l = ((l - rl).abs() / rl.clamp(min=1)).max().item()
        empty_ok = bool(torch.all(m[~live] == -1e30)
                        and torch.all(l[~live] == 0)
                        and torch.all(acc[~live] == 0))
        n_att = sum(min(x, win) if win else x for x in lens)
        nbytes = (q.numel() * 2 + n_att * hkv * d * 2 * 2 + bt.numel() * 4
                  + B * 4 + acc.numel() * 4 + 2 * m.numel() * 4)
        b_ms, b_by = bound(nbytes, 4.0 * n_att * hq * d)
        out.append({
            "kernel": "paged_attention_decode_stats",
            "case": f"{what} B={B} Hq={hq} Hkv={hkv} D={d} page={page}"
                    + (f" window={win}" if win else ""),
            "lens": lens,
            "max_abs_err": err, "max_abs_err_m": err_m,
            "max_rel_err_l": err_l, "tol": 1e-3,
            "tol_rule": "1e-3 on acc/l and m, 1e-3 relative on l "
                        "(f32 math on the same bf16 K/V)",
            "ms": time_ms(lambda: paged_attention_decode_stats(
                q, kp, vp, bt, ln, page, sliding_window=win)),
            "plain_ms": time_ms(lambda: paged_attention_reference_stats(
                q, kp, vp, bt, ln, sliding_window=win)),
            "library_ms": time_ms(_sdpa_yardstick(torch, q, kp, vp, bt, lens,
                                                  win)),
            "library": "F.scaled_dot_product_attention on gathered K/V",
            "bound_ms": b_ms, "bound_by": b_by, "split_keys": S,
            "passed": (err <= 1e-3 and err_m <= 1e-3 and err_l <= 1e-3
                       and empty_ok)})
        if what.startswith(("7B decode", "Mistral")):
            out[-1]["ms_by_split"] = {sk: time_ms(lambda: _decode_cuda(
                q, kp, vp, bt, ln, win, False, sk)) for sk in SPLIT_SWEEP}
    return out


def paged_norm_cases(torch, dev, gen):
    """Kernel 6, the normalised paged decode behind ``paged_attention()``,
    against ``paged_attention_reference`` (lengths include the current
    token, the window is not shrunk): Mistral-7B decode (GQA 4:1), one
    long Mistral row where the 4096 window bites, and Llama-2-7B MHA. q
    and the output are bf16: f32 math on both sides, then one rounding."""
    from bigdl_tpu_torch.llm.kernels.paged_attention import (
        SPLIT_KEYS, _decode_cuda, paged_attention_decode,
        paged_attention_reference)
    page = 16
    out = []
    for what, hq, hkv, d, win, lens in (
            ("split boundaries window=300", 32, 8, 128, 300,
             [x for x in _split_lens(SPLIT_KEYS) if x]),
            ("Mistral decode", 32, 8, 128, 4096, [513, 534, 555, 576]),
            ("Mistral long", 32, 8, 128, 4096, [4233]),
            ("7B MHA", 32, 32, 128, None, LENS_MAIN),
            ("GLM-4-9B decode", 32, 2, 128, None,
             [x + 1 for x in GLM_DECODE_LENS]),
            ("StarCoder-15B decode", 48, 1, 128, None,
             [x + 1 for x in GLM_DECODE_LENS])):
        q, kp, vp, bt, ln = _paged_inputs(torch, dev, gen, hq, hkv, d, lens)
        B = len(lens)
        got = paged_attention_decode(q, kp, vp, bt, ln, page,
                                     sliding_window=win)
        want = paged_attention_reference(q, kp, vp, bt, ln,
                                         sliding_window=win)
        torch.cuda.synchronize()
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-3 + 2.0 ** -7 * scale
        n_att = sum(min(x, win) if win else x for x in lens)
        nbytes = (q.numel() * 2 + n_att * hkv * d * 2 * 2 + bt.numel() * 4
                  + B * 4 + got.numel() * 2)
        b_ms, b_by = bound(nbytes, 4.0 * n_att * hq * d)
        out.append({
            "kernel": "paged_attention_decode",
            "case": f"{what} B={B} Hq={hq} Hkv={hkv} D={d} page={page}"
                    + (f" window={win}" if win else ""),
            "lens": lens, "max_abs_err": err, "tol": tol,
            "tol_rule": "1e-3 + one bf16 ulp of max|plain| (2^-7 of it): "
                        "f32 math on the same bf16 q and K/V, each side "
                        "rounds its output to bf16 once",
            "ms": time_ms(lambda: paged_attention_decode(
                q, kp, vp, bt, ln, page, sliding_window=win)),
            "plain_ms": time_ms(lambda: paged_attention_reference(
                q, kp, vp, bt, ln, sliding_window=win)),
            "library_ms": time_ms(_sdpa_yardstick(torch, q, kp, vp, bt, lens,
                                                  win)),
            "library": "F.scaled_dot_product_attention on gathered K/V",
            "bound_ms": b_ms, "bound_by": b_by, "split_keys": SPLIT_KEYS,
            "passed": err <= tol and bool(torch.isfinite(got).all())})
        if not what.startswith("split"):
            out[-1]["ms_by_split"] = {sk: time_ms(lambda: _decode_cuda(
                q, kp, vp, bt, ln, win, True, sk)) for sk in SPLIT_SWEEP}
    return out


# kernel 3's cases: (what, Hq, Hkv, D, offset, seq_len, Tq, window, pools'
# dtype); whole-prompt prefills run at offset 0, a cached suffix at its
# prefix's length (phase 3b (a): 1024) and a chunk at its start (phase 3b
# (b)'s last chunk: 1472)
RAGGED_SHAPES = (
    ("7B prefill", 32, 32, 128, 0, 300, 512, None, "bf16"),
    ("7B cached tail", 32, 32, 128, 1024, 300, 512, None, "bf16"),
    # phase 3e: a whole prefill of 1,024 + 300 tokens, the shortest pass-2
    # tail behind a fetched prefix, and the handoff's one-token suffix
    ("7B prefill of 1,024 + tail", 32, 32, 128, 0, 1324, 2048, None, "bf16"),
    ("7B fetched prefix, short tail", 32, 32, 128, 1024, 33, 64, None,
     "bf16"),
    ("7B one-token suffix", 32, 32, 128, 1280, 1, 16, None, "bf16"),
    ("7B last chunk", 32, 32, 128, 1472, 64, 64, None, "bf16"),
    ("7B offset>0", 32, 32, 128, 64, 200, 256, None, "bf16"),
    ("GQA Hkv=8", 32, 8, 128, 32, 256, 256, None, "bf16"),
    ("D=64", 32, 32, 64, 20, 100, 128, None, "bf16"),
    ("GQA window=64", 32, 8, 128, 48, 150, 256, 64, "bf16"),
    ("Mistral prefill", 32, 8, 128, 0, 512, 512, 4096, "bf16"),
    ("Mistral offset>0", 32, 8, 128, 3800, 400, 512, 4096, "bf16"),
    ("GLM-4-9B prefill", 32, 2, 128, 0, 1000, 1024, None, "bf16"),
    ("GLM-4-9B offset>0", 32, 2, 128, 700, 300, 512, None, "bf16"),
    ("D=96", 64, 8, 96, 40, 200, 256, None, "bf16"),
    # the speculative verify chunk at 7B (phase 3c): 2, 4 and 8 rows, some
    # of them padding, at offsets off the page and the 64-key tile
    ("7B verify W=2", 32, 32, 128, 17, 2, 2, None, "bf16"),
    ("7B verify W=4", 32, 32, 128, 301, 4, 4, None, "bf16"),
    ("7B verify W=8", 32, 32, 128, 1001, 8, 8, None, "bf16"),
    ("7B verify W=8, 5 live", 32, 32, 128, 1001, 5, 8, None, "bf16"),
    # Mixtral's (phase 9, GQA 4:1, no window): a served prefill, a prompt
    # suffix behind a cached 128-token prefix, a 256-token chunk of the
    # 1024-token prompt, and its verify chunks (spec_k 8)
    ("Mixtral prefill", 32, 8, 128, 0, 300, 512, None, "bf16"),
    ("Mixtral cached suffix", 32, 8, 128, 128, 47, 64, None, "bf16"),
    ("Mixtral chunk", 32, 8, 128, 768, 256, 256, None, "bf16"),
    ("Mixtral verify W=8", 32, 8, 128, 301, 8, 8, None, "bf16"),
    ("Mixtral verify W=8, 5 live", 32, 8, 128, 293, 5, 8, None, "bf16"),
    # the served 7B prefill with an f32 KV cache: the CUDA-core route
    ("7B prefill f32 cache", 32, 32, 128, 0, 300, 512, None, "f32"))


def ragged_cases(torch, dev, gen, shapes=RAGGED_SHAPES):
    """Kernel 3 on its route (``ragged_route``) against both plain
    versions: the tensor-core kernel (bf16) within 2^-8 max|V| (P rounded
    to bf16, relative 2^-9, on a convex combination of V rows), the
    CUDA-core kernel (f32 math) within 1e-3; padded rows 0. Every bf16
    row also holds and times the CUDA-core kernel on the same inputs
    (``ms_tc``, ``ms_cuda_core``), beside SDPA on the gathered K/V and
    SDPA's own error against the plain version."""
    import torch.nn.functional as F
    from bigdl_tpu_torch.llm.kernels.ragged_prefill import (
        _ragged_cuda, ragged_prefill_attention, ragged_prefill_reference,
        ragged_route, ragged_tiles_reference)
    page = 16
    out = []
    for what, hq, hkv, d, off, slen, tq, win, kv in shapes:
        kvt = torch.bfloat16 if kv == "bf16" else torch.float32
        maxp = -(-(off + 1) // page) + 1
        P = 1 + maxp + 8
        q = torch.randn((1, tq, hq, d), generator=gen, device=dev).to(
            torch.bfloat16)
        ks, vs = (torch.randn((1, tq, hkv, d), generator=gen, device=dev)
                  .to(kvt) for _ in range(2))
        kp, vp = (torch.randn((P, hkv, page, d), generator=gen, device=dev)
                  .to(kvt) for _ in range(2))
        bt = (1 + torch.randperm(P - 1, generator=gen, device=dev)[
            :maxp]).reshape(1, maxp).to(torch.int32)
        offs = torch.tensor([off], dtype=torch.int32, device=dev)
        lens = torch.tensor([slen], dtype=torch.int32, device=dev)
        args = (q, ks, vs, kp, vp, bt, offs, lens)
        route = ragged_route(q, kp)
        got = ragged_prefill_attention(*args, page_size=page,
                                       sliding_window=win)
        want = ragged_prefill_reference(*args, sliding_window=win)
        torch.cuda.synchronize()
        vmax = max(vs.float().abs().max().item(),
                   vp.float().abs().max().item())
        tol_tc, tol_cc = 2.0 ** -8 * vmax, 1e-3
        tol = tol_tc if route == "tc" else tol_cc
        err = (got[:, :slen] - want[:, :slen]).abs().max().item()
        padded_zero = not got[:, slen:].any().item()
        # library yardstick: SDPA over gathered prefix + suffix K/V
        g = hq // hkv
        kpre = _gathered(torch, kp, bt, off, g) if off else None
        vpre = _gathered(torch, vp, bt, off, g) if off else None
        ksuf = ks[0, :slen].permute(1, 0, 2).repeat_interleave(g, 0)[None]
        vsuf = vs[0, :slen].permute(1, 0, 2).repeat_interleave(g, 0)[None]
        kall = (torch.cat([kpre, ksuf], 2) if off else ksuf).to(q.dtype)
        vall = (torch.cat([vpre, vsuf], 2) if off else vsuf).to(q.dtype)
        qpos = off + torch.arange(slen, device=dev)[:, None]
        kpos = torch.arange(off + slen, device=dev)[None]
        mask = kpos <= qpos
        if win is not None:
            mask &= kpos > qpos - win
        ql = q[0, :slen].permute(1, 0, 2)[None]
        sdpa = F.scaled_dot_product_attention(ql, kall, vall, attn_mask=mask)
        sdpa_err = (sdpa[0].permute(1, 0, 2).float()
                    - want[0, :slen]).abs().max().item()
        keys = [min(off + j + 1, win) if win else off + j + 1
                for j in range(slen)]
        # prefix positions some query needs (the window may drop some)
        n_pre = off - (max(0, off - win + 1) if win else 0)
        # each input read once: the live rows of q and of the suffix K/V,
        # the prefix rows the queries need; all Tq output rows written
        kvb = kp.element_size()
        nbytes = (slen * hq * d * 2 + 2 * slen * hkv * d * kvb
                  + n_pre * hkv * d * kvb * 2 + got.numel() * 4)
        b_ms, b_by = bound(nbytes, 4.0 * sum(keys) * hq * d)
        row = {
            "kernel": "ragged_prefill_attention"
                      + ("_tc" if route == "tc" else ""),
            "route": route,
            "case": f"{what} Tq={tq} seq_len={slen} offset={off} Hq={hq} "
                    f"Hkv={hkv} D={d}" + (f" window={win}" if win else "")
                    + f" {kv} pools",
            "max_abs_err": err, "tol": tol,
            "tol_rule": "tensor cores: 2^-8 * max|V| of both plain versions "
                        "(P rounded to bf16); CUDA cores: 1e-3 (f32 "
                        "softmax of the same K/V); padded rows 0",
            "max_abs_err_sdpa": sdpa_err,
            "ms": time_ms(lambda: ragged_prefill_attention(
                *args, page_size=page, sliding_window=win)),
            "plain_ms": time_ms(lambda: ragged_prefill_reference(
                *args, sliding_window=win)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                ql, kall, vall, attn_mask=mask)),
            "library": "F.scaled_dot_product_attention on gathered bf16 K/V",
            "bound_ms": b_ms, "bound_by": b_by,
            "passed": err <= tol and padded_zero
                      and bool(torch.isfinite(got).all())}
        if route == "tc":
            tiles = ragged_tiles_reference(*args, sliding_window=win)
            e = (got[:, :slen] - tiles[:, :slen]).abs().max().item()
            row["max_abs_err_vs_tiles_model"] = e
            row["passed"] &= e <= tol_tc
            for r, t in (("tc", tol_tc), ("cuda_core", tol_cc)):
                e = (_ragged_cuda(*args, win, r)[:, :slen]
                     - want[:, :slen]).abs().max().item()
                row[f"max_abs_err_{r}"] = e
                row["passed"] &= e <= t
                row[f"ms_{r}"] = time_ms(lambda: _ragged_cuda(*args, win, r))
            del tiles
        out.append(row)
        del q, ks, vs, kp, vp, got, want, kall, vall, sdpa
    return out


# -- phase 3: the served path at 7B -------------------------------------------

def _path_expect(model, buckets, steps, paged=True):
    """What ``LLMServer`` must launch for prefill legs at ``buckets`` (one
    for each whole prefill, cached suffix or chunk: a power of two, at
    least one page) and ``steps`` decode legs: each prefill leg's q4_0
    linears (a llama model's 4 a layer and a quantized lm_head, a
    family's 6 a layer; a bf16 model's linears, Mixtral's, launch none
    of ours) on the route of (bucket, N), its
    attention on the route of the pools (``ragged_route``), one ragged
    kernel a layer; every decode leg runs the linears at M = max_batch
    <= 8 (the GEMV) and one stats kernel a layer. ``paged=False``: the
    slot-static engine, whose broadcast prefill (``buckets`` are then
    its rows, max_batch x prompt) and decode step attend with
    ``_attention`` and launch no attention kernel."""
    import torch
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.kernels.ragged_prefill import ragged_route
    cfg, params = model.config, model.params
    L = cfg.num_hidden_layers
    ns = [(lp["q"].shape[-1], L) for lp in params["layers"].values()
          if isinstance(lp, dict) and "q" in lp]
    if "q" in params.get("lm_head", {}):
        ns.append((params["lm_head"]["q"].shape[-1], 1))
    per_pass = sum(c for _, c in ns)
    # the route of the prefill attention's inputs: bf16 q (the served
    # activations) over pools of the model's cache dtype
    tc_attn = ragged_route(
        torch.empty((0, 0, 0, cfg.head_dim), dtype=torch.bfloat16),
        torch.empty((0, 0, model.page_size, cfg.head_dim),
                    dtype=model.cache_dtype)) == "tc"
    expect = dict.fromkeys(kernels.launch_counts(), 0)
    tc = sum(c for bk in buckets for n, c in ns
             if kernels.matmul_route(bk, n) == "tc")
    expect.update({
        "int4_matmul": (len(buckets) + steps) * per_pass,
        "int4_matmul_tc": tc,
        "int4_matmul_gemv": (len(buckets) + steps) * per_pass - tc,
        "paged_attention_decode_stats": steps * L * paged,
        "ragged_prefill_attention": len(buckets) * L * paged,
        "ragged_prefill_attention_tc": len(buckets) * L * (paged
                                                           and tc_attn)})
    return expect


def _bucket(n, page=16):
    return max(page, 1 << (n - 1).bit_length())


def _serve_expect(model, prompts, steps):
    """:func:`_path_expect` of ``prompts`` each prefilled whole, alone;
    returns ``(buckets, {wrapper: launches})``."""
    buckets = [_bucket(len(p), model.page_size) for p in prompts]
    return buckets, _path_expect(model, buckets, steps)


def _serve_run(torch, model, prompts, new, what, warmup=None,
               buckets=None, **kw):
    """Serve ``prompts`` (``new`` greedy tokens each, all submitted at
    once) on a fresh ``LLMServer(model, **kw)`` after a 2-token warm-up
    request (``warmup``, default the first prompt's first 20 tokens),
    which runs the first decode step eagerly and captures the second as
    the server's CUDA graph (outside the measured window, as are the
    CUDA context, kernel loads and cuBLAS handles). Checks: no engine
    error, every measured step a graph replay, in-vocab tokens of the
    asked count, and launch counts (zeroed just before) exactly what the
    path must launch, its prefill legs at ``buckets`` (default: each
    prompt whole). Returns ``(row, outputs)``: TTFT, decode tok/s and
    step ms over the window where every request decodes, the host's
    dispatch and drain-wait time a step, the graph's capture seconds and
    pool bytes, and peak memory."""
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.serving import LLMServer

    cfg = model.config
    srv = LLMServer(model, **kw).start()
    paged = srv.paged
    try:
        srv.submit(prompts[0][:20] if warmup is None else warmup,
                   max_new_tokens=2).get(timeout=600)
        check(not srv.errors, f"{what}: engine errors: {srv.errors}")
        graph = srv._decode
        check(graph.graph is not None, f"{what}: the step was not captured")
        steps0, replays0 = srv.steps, graph.replays
        host0, stall0 = srv.host_seconds, srv.stall_seconds
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t_start = time.perf_counter()
        reqs = [srv.submit(p, max_new_tokens=new) for p in prompts]
        outs = [r.get(timeout=900) for r in reqs]
        t_end = time.perf_counter()
        counts = kernels.launch_counts()
        steps = srv.steps - steps0
        replays = graph.replays - replays0
        host_s, stall_s = srv.host_seconds - host0, srv.stall_seconds - stall0
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        kv = srv._kv.debug_stats() if paged else None
    finally:
        srv.stop()
    check(not srv.errors, f"{what}: engine errors: {srv.errors}")
    check(graph.graph is None, f"{what}: stop() left the graph alive")
    check(replays == steps, f"{what}: {replays} replays for {steps} steps")
    for i, toks in enumerate(outs):
        check(len(toks) == new and all(0 <= t < cfg.vocab_size
                                       for t in toks),
              f"{what} request {i}: tokens {toks}")
    if buckets is None:
        buckets = ([_bucket(len(p), model.page_size) for p in prompts]
                   if paged else [srv.max_batch * len(p) for p in prompts])
    expect = _path_expect(model, buckets, steps, paged)
    check(all(counts[k] > 0 for k, v in expect.items() if v),
          f"{what}: a kernel of the served path never ran: {counts}")
    check(counts == expect, f"{what}: launch counts {counts} != expected "
          f"{expect}")
    ttft = [r.t_first_token - r.t_submit for r in reqs]
    decode_s = t_end - max(r.t_first_token for r in reqs)
    return {"pipeline_depth": srv.pipeline_depth, "requests": len(prompts),
            "prompt_lens": [len(p) for p in prompts],
            "prefill_buckets": buckets, "max_new_tokens": new,
            "decode_steps": steps, "graph_replays": replays,
            "launches": counts,
            "step_launches": {k: v for k, v in graph.launches.items() if v},
            "ttft_ms_mean": statistics.mean(ttft) * 1e3,
            "ttft_ms_max": max(ttft) * 1e3, "wall_s": t_end - t_start,
            "decode_tok_per_s": sum(len(o) - 1 for o in outs) / decode_s,
            "decode_step_ms": decode_s / max(steps - 1, 1) * 1e3,
            "host_dispatch_ms_per_step": host_s / steps * 1e3,
            "drain_wait_ms_per_step": stall_s / steps * 1e3,
            "graph_capture_s": graph.capture_seconds,
            "graph_pool_mb": graph.pool_bytes / 2**20,
            "peak_mem_gb": peak / 1e9, "peak_reserved_gb": reserved / 1e9,
            "kv": kv, "tokens_first_request": outs[0]}, outs


SERVE_7B = dict(max_batch=8, max_seq_len=512, page_size=16)


def _phase3_prompts(torch, cfg):
    """Phase 3's 8 prompts of 17..300 tokens, from a seed."""
    gen = torch.Generator().manual_seed(1)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()
            for n in (17, 57, 98, 139, 180, 220, 260, 300)]


def serve_7b(torch, dev):
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.models.llama import LlamaConfig, LlamaForCausalLM
    from bigdl_tpu_torch.llm.serving import LLMServer

    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM.synthetic_q4(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = _phase3_prompts(torch, cfg)
    kw = SERVE_7B

    # the default depth (2), then the synchronous engine on the same graph
    row, outs = _serve_run(torch, model, prompts, 32, "7B depth 2", **kw)
    check(row["pipeline_depth"] == 2, "the default depth is not 2")
    row1, outs1 = _serve_run(torch, model, prompts, 32, "7B depth 1",
                             pipeline_depth=1, **kw)
    check(outs1 == outs, "7B tokens at depth 1 differ from depth 2")

    # one request again, alone, on a fresh server: the same tokens
    alone_i = 3
    srv2 = LLMServer(model, **kw).start()
    try:
        alone = srv2.submit(prompts[alone_i], max_new_tokens=32).get(
            timeout=600)
    finally:
        srv2.stop()
    check(alone == outs[alone_i], f"request {alone_i} alone {alone} != "
          f"batched {outs[alone_i]}")

    # the same request on a server with an f32 KV cache: its prefill
    # attention takes the CUDA-core kernel (f32 pools), its decode the f32
    # instance of the stats kernel
    f32_model = LlamaForCausalLM(cfg, model.params,
                                 cache_dtype=torch.float32, device=dev)
    srv3 = LLMServer(f32_model, **kw).start()
    try:
        steps0 = srv3.steps
        kernels.reset_launch_counts()
        toks32 = srv3.submit(prompts[alone_i], max_new_tokens=32).get(
            timeout=600)
        counts32 = kernels.launch_counts()
        steps32 = srv3.steps - steps0
    finally:
        srv3.stop()
    check(not srv3.errors, f"f32-cache engine errors: {srv3.errors}")
    _, want32 = _serve_expect(f32_model, prompts[alone_i:alone_i + 1],
                              steps32)
    check(counts32 == want32, f"f32-cache launch counts {counts32} != "
          f"{want32}")
    check(len(toks32) == 32 and all(0 <= t < cfg.vocab_size
                                    for t in toks32),
          f"f32-cache tokens {toks32}")
    del srv3, f32_model
    return {
        "phase": "serve", "model": "Llama-2-7B q4_0 (synthetic weights, "
        "32 layers, full width)", **row, "weights_build_s": build_s,
        "alone_equals_batched": True, "depth1": row1, "outputs": outs,
        "depth1_tokens_equal": True,
        "f32_cache": {"request": alone_i, "launches": counts32,
                      "decode_steps": steps32, "tokens": toks32,
                      "leading_tokens_equal_to_bf16_cache": next(
                          (i for i, (a, b) in enumerate(zip(toks32, alone))
                           if a != b), len(alone))}}, model


# -- phase 3d: the slot-static engine at 7B ------------------------------------

def serve_slotted(torch, model, paged_row, paged_outs):
    """Phase 3's 8 requests on the slot-static engine
    (``LLMServer(paged=False)``: a dense 512-token window a slot, the
    prompt prefilled by the broadcast pass, the decode step one CUDA
    graph) at depths 2 and 1: exact launch counts (each prefill's
    linears at M = 8 x its prompt on their route, the decode linears on
    the GEMV, no attention kernel), the same tokens at both depths, and
    where they part from the paged engine's (phase 3, same model)."""
    prompts = _phase3_prompts(torch, model.config)
    kw = dict(SERVE_7B, paged=False)
    row, outs = _serve_run(torch, model, prompts, 32,
                           "7B slot-static depth 2", **kw)
    row1, outs1 = _serve_run(torch, model, prompts, 32,
                             "7B slot-static depth 1", pipeline_depth=1,
                             **kw)
    check(outs1 == outs, "7B slot-static tokens at depth 1 differ from "
          "depth 2")
    return {"phase": "serve_slotted", "model": "Llama-2-7B q4_0 (phase "
            "3's model)", **row, "depth1": row1,
            "depth1_tokens_equal": True,
            "leading_tokens_equal_to_paged": [
                _lead(a, b) for a, b in zip(outs, paged_outs)],
            "paged": {k: paged_row[k] for k in (
                "decode_tok_per_s", "decode_step_ms", "ttft_ms_mean",
                "ttft_ms_max", "peak_mem_gb", "host_dispatch_ms_per_step")}}


def profile_slotted(torch, model):
    """The slot-static 7B decode step (batch 8, positions 33..316 in a
    512-token window of random K/V): eager, then as the engine runs it,
    one captured CUDA graph (``bind_slotted_step``) held bit for bit
    against the eager step over 4 steps (tokens, logits, positions, the
    cache), both traced as in phase 4."""
    from bigdl_tpu_torch.llm.graphs import CapturedStep
    from bigdl_tpu_torch.llm.kernels.sampling import sample_tokens
    from bigdl_tpu_torch.llm.models.llama import init_cache
    from bigdl_tpu_torch.llm.serving import (bind_slotted_step,
                                             slotted_decode_step)

    cfg, dev, B = model.config, model.device, 8
    gen = torch.Generator(device=dev).manual_seed(13)
    cache = init_cache(cfg, B, SERVE_7B["max_seq_len"],
                       dtype=model.cache_dtype, device=dev)
    for t in cache["k"], cache["v"]:
        t.normal_(generator=gen)
    st = {"k": cache["k"], "v": cache["v"],
          "pos": torch.tensor([33, 73, 114, 155, 196, 236, 276, 316],
                              dtype=torch.int32, device=dev),
          "last": torch.randn((B, cfg.vocab_size), generator=gen,
                              device=dev),
          "active": torch.ones(B, dtype=torch.bool, device=dev),
          "toks": torch.zeros(B, dtype=torch.int32, device=dev)}
    del cache
    g = {k: v.clone() for k, v in st.items()}
    e = st

    def eager():
        t = sample_tokens(e["last"])
        e["last"] = slotted_decode_step(model.params, cfg, e["k"], e["v"],
                                        e["pos"], t)
        e["pos"] = e["pos"] + e["active"].to(torch.int32)
        return t

    captured = CapturedStep(bind_slotted_step(
        model.params, cfg, *(g[k] for k in (
            "k", "v", "pos", "last", "active", "toks"))), dev)
    with torch.inference_mode():
        for i in range(4):
            captured()
            t = eager()
            check(torch.equal(t, g["toks"])
                  and torch.equal(e["last"], g["last"])
                  and torch.equal(e["pos"], g["pos"]),
                  f"graphed slot-static step {i} differs from the eager "
                  "step")
        check(torch.equal(e["k"], g["k"]) and torch.equal(e["v"], g["v"]),
              "graphed slot-static steps wrote another cache than the "
              "eager steps")
    row = profile(torch, lambda: eager().cpu(),
                  "7B slot-static decode step, batch 8, positions 37..")
    del e, st
    row["graph"] = profile_graphed(
        torch, captured, lambda: g["toks"].cpu(),
        "7B slot-static decode step as one CUDA graph, batch 8")
    row["graph_bit_equal_to_eager_steps"] = 4
    captured.close()
    return row


# -- phase 3b: the prefix cache and mixed dispatch at 7B -----------------------

# (a): a shared 1,024-token prefix (64 pages) before phase 3's tails; (b):
# 7 decoding requests, then one uncached 1,536-token prompt in chunks of 64.
# (b)'s prompt lengths each end in a last chunk of >= TC_MIN_M rows (or are
# one chunk), so a prompt's chunks run the linears on the tensor cores as
# its whole prefill does and the rows decode from the same state either way
PREFIX_TOKENS, PREFIX_TAILS = 1024, (17, 57, 98, 139, 180, 220, 260, 300)
MIXED_PROMPTS, MIXED_NEW = (17, 57, 98, 163, 180, 237, 300), 64
MIXED_LONG, MIXED_LONG_NEW, MIXED_CHUNK = 1536, 32, 64
BIG = dict(max_batch=8, max_seq_len=2048, page_size=16)


def _chunk_buckets(T, chunk, page=16):
    """The buckets of a prompt of ``T`` uncached tokens fed in chunks of
    ``chunk`` (``LLMServer._chunk_end``'s page-aligned cuts)."""
    out, off = [], 0
    while off < T:
        end = min(max((off + chunk) // page * page, off + 1), T)
        out.append(_bucket(end - off, page))
        off = end
    return out


def _first_logits(torch, model, prompts, **kw):
    """The 8 prompts admitted in one pass on a fresh server, driven inline
    (no decode): ``_last`` then holds each one's first-token logits."""
    from bigdl_tpu_torch.llm.serving import LLMServer
    srv = LLMServer(model, **kw)
    reqs = [srv.submit(p, max_new_tokens=32) for p in prompts]
    srv._admit()
    check([id(r) for r in srv._slots] == [id(r) for r in reqs],
          "the 8 prompts were not admitted in one pass")
    last, stats = srv._last.clone(), srv._kv.debug_stats()
    srv.stop(drain=False)
    check(not srv.errors, f"engine errors: {srv.errors}")
    del srv
    torch.cuda.empty_cache()
    return last, stats


def _rel_err(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def serve_prefix_cache(torch, model, label="7B",
                       name="Llama-2-7B q4_0 (phase 3's model)"):
    """(a) 8 greedy requests sharing a 1,024-token prefix, then tails of
    17..300 tokens (each tail's first token distinct), 32 new each, with
    ``kvcache=True`` and off: 7 hits reusing 1,024 tokens each, each
    request's first-token logits within 2e-2 of the cache-off engine's,
    TTFT and decode tok/s both ways, and exact launch counts (the cached
    prefills at their tails' buckets)."""
    cfg = model.config
    gen = torch.Generator().manual_seed(4)
    prefix = torch.randint(0, cfg.vocab_size, (PREFIX_TOKENS,),
                           generator=gen)
    prompts = []
    for j, n in enumerate(PREFIX_TAILS):
        tail = torch.randint(0, cfg.vocab_size, (n,), generator=gen)
        tail[0] = j + 1
        prompts.append(torch.cat([prefix, tail]).numpy())
    warm = torch.randint(0, cfg.vocab_size, (20,), generator=gen)
    warm[0] = 0
    whole = [_bucket(len(p)) for p in prompts]
    cached = whole[:1] + [_bucket(n) for n in PREFIX_TAILS[1:]]
    out = {}
    for kv, buckets in ((False, whole), (True, cached)):
        name = f"prefix cache {'on' if kv else 'off'}"
        first, stats = _first_logits(torch, model, prompts, kvcache=kv,
                                     **BIG)
        row, outs = _serve_run(torch, model, prompts, 32, f"{label} {name}",
                               warmup=warm.numpy(), buckets=buckets,
                               kvcache=kv, **BIG)
        torch.cuda.empty_cache()
        hits = 7 if kv else 0
        for st in (stats, row["kv"]):
            check(st["hits"] == hits and st["prefix_tokens_reused"]
                  == hits * PREFIX_TOKENS, f"{name}: {st}")
        out[kv] = (row, outs, first)
    errs = [_rel_err(out[True][2][i], out[False][2][i]) for i in range(8)]
    check(max(errs) <= 2e-2, f"prefix cache: first-token logits {errs}")
    lead = [next((k for k, (a, b) in enumerate(zip(x, y)) if a != b),
                 len(x)) for x, y in zip(out[True][1], out[False][1])]
    return {"phase": "serve_prefix_cache", "model": name,
            "prefix_tokens": PREFIX_TOKENS,
            "tails": PREFIX_TAILS, "on": out[True][0],
            "off": out[False][0],
            "first_logits_max_rel_err": errs, "tol": 2e-2,
            "first_logits_bit_equal": [bool(torch.equal(
                out[True][2][i], out[False][2][i])) for i in range(8)],
            "leading_equal_tokens": lead,
            "ttft_ms_mean_on_off": [out[True][0]["ttft_ms_mean"],
                                    out[False][0]["ttft_ms_mean"]],
            "ttft_ms_max_on_off": [out[True][0]["ttft_ms_max"],
                                   out[False][0]["ttft_ms_max"]]}


def _serve_inline(srv, prompts, n, late, late_n):
    """Serve ``prompts`` driven inline (``_admit`` then ``_step_paged``,
    the engine loop's pass); once each has 2 tokens, submit ``late``.
    Returns the requests, ``late``'s, and its first-token logits, read
    from ``_last`` right after its prefill (whole, or the final chunk)."""
    reqs = [srv.submit(p, max_new_tokens=n) for p in prompts]
    lr, first = None, None

    def read_first():
        i = srv._slots.index(lr) if lr in srv._slots else -1
        return srv._last[i].clone() if first is None and i >= 0 and \
            srv._remaining[i] == late_n else first

    while lr is None or not all(r.done.is_set() for r in reqs + [lr]):
        srv._admit()
        first = read_first()
        if lr is None and all(len(r.tokens) >= 2 for r in reqs):
            lr = srv.submit(late, max_new_tokens=late_n)
            continue
        srv._step_paged()
        first = read_first()
    while srv._inflight:
        srv._drain_next()
    return reqs, lr, first


def _mixed_run(torch, model, prompts, long_prompt, mixed, what):
    """(b)'s timed run, served by the engine's thread: a warm-up first (a
    request decoding while a 3-chunk prompt arrives: the decode graph and,
    with ``mixed``, bucket 64's mixed graph are captured outside the
    window), then the 7 requests, and once each has 2 tokens the long
    prompt. Checks: no engine error, every measured step a replay of its
    graph, exact launch counts (the chunks at their buckets), in-vocab
    tokens. Reports the long request's TTFT, the 7 rows' decode tok/s
    over its admission window (submit to first token) and their longest
    gap between tokens across it."""
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.serving import LLMServer
    cfg = model.config
    srv = LLMServer(model, mixed=mixed, chunk_tokens=MIXED_CHUNK,
                    **BIG).start()
    try:
        w = srv.submit(prompts[0], max_new_tokens=24)
        while len(w.tokens) < 2:
            time.sleep(0.0005)
        srv.submit(long_prompt[:192], max_new_tokens=2).get(timeout=600)
        w.get(timeout=600)
        check(not srv.errors, f"{what}: engine errors: {srv.errors}")
        graphs = {"decode": srv._decode}
        if mixed:
            check(list(srv._mixed_steps) == [MIXED_CHUNK],
                  f"{what}: mixed buckets {list(srv._mixed_steps)}")
            graphs["mixed"] = srv._mixed_steps[MIXED_CHUNK][0]
        check(all(g.graph is not None for g in graphs.values()),
              f"{what}: a step was not captured in the warm-up")
        c0 = (srv.steps, srv.prefill_chunks_total, srv.mixed_passes,
              {k: g.replays for k, g in graphs.items()})
        kernels.reset_launch_counts()
        reqs = [srv.submit(p, max_new_tokens=MIXED_NEW) for p in prompts]
        while any(len(r.tokens) < 2 for r in reqs):
            time.sleep(0.0005)
        lr = srv.submit(long_prompt, max_new_tokens=MIXED_LONG_NEW)
        outs = [r.get(timeout=900) for r in reqs]
        lout = lr.get(timeout=900)
        counts = kernels.launch_counts()
        steps, chunks, passes = (srv.steps - c0[0],
                                 srv.prefill_chunks_total - c0[1],
                                 srv.mixed_passes - c0[2])
        replays = {k: g.replays - c0[3][k] for k, g in graphs.items()}
        captures = {k: g.capture_seconds for k, g in graphs.items()}
    finally:
        srv.stop()
    check(not srv.errors, f"{what}: engine errors: {srv.errors}")
    check(replays["decode"] == steps - passes
          and replays.get("mixed", 0) == passes,
          f"{what}: replays {replays} for {steps} steps, {passes} mixed")
    whole, chunked = [], []
    for p in list(prompts) + [long_prompt]:
        if mixed and len(p) > MIXED_CHUNK:
            chunked += _chunk_buckets(len(p), MIXED_CHUNK)
        else:
            whole.append(_bucket(len(p)))
    check(chunks == len(chunked), f"{what}: {chunks} chunks, expected "
          f"{len(chunked)}")
    expect = _path_expect(model, whole + chunked, steps)
    check(counts == expect, f"{what}: launch counts {counts} != {expect}")
    for toks, n in [(o, MIXED_NEW) for o in outs] + [(lout, MIXED_LONG_NEW)]:
        check(len(toks) == n and all(0 <= t < cfg.vocab_size for t in toks),
              f"{what}: tokens {toks}")
    t0, t1 = lr.t_submit, lr.t_first_token
    in_win = sum(t0 <= t <= t1 for r in reqs for t in r.t_tokens)
    gaps = [b - a for r in reqs for a, b in zip(r.t_tokens, r.t_tokens[1:])
            if b >= t0 and a <= t1]
    all_gaps = [b - a for r in reqs
                for a, b in zip(r.t_tokens, r.t_tokens[1:])]
    return {"what": what, "mixed": mixed, "launches": counts,
            "decode_steps": steps, "prefill_chunks": chunks,
            "mixed_passes": passes, "graph_replays": replays,
            "graph_capture_s": captures,
            "long_ttft_ms": (t1 - t0) * 1e3,
            "rows_tok_per_s_in_window": in_win / (t1 - t0),
            "rows_max_gap_ms_in_window": max(gaps) * 1e3,
            "rows_gap_ms_in_window_p50_p90": [
                statistics.median(gaps) * 1e3,
                statistics.quantiles(gaps, n=10)[-1] * 1e3],
            "rows_max_gap_ms": max(all_gaps) * 1e3,
            "rows_median_gap_ms": statistics.median(all_gaps) * 1e3,
            "tokens_first_request": outs[0]}, outs


def serve_mixed(torch, model):
    """(b) 7 requests of 17..300 tokens decode 64 new tokens each when an
    uncached 1,536-token prompt arrives, served with ``mixed=True``
    (chunks of 64) and ``mixed=False``: driven inline, the 7 rows' tokens
    identical between the modes and the long request's first-token
    logits within 2e-2; then served by the engine's thread (timed), the
    same tokens, one capture of bucket 64 and every mixed pass a replay,
    exact launch counts."""
    from bigdl_tpu_torch.llm.serving import LLMServer
    cfg = model.config
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()
               for n in MIXED_PROMPTS]
    long_prompt = torch.randint(0, cfg.vocab_size, (MIXED_LONG,),
                                generator=gen).numpy()
    inline, runs = {}, {}
    for mixed in (False, True):
        srv = LLMServer(model, mixed=mixed, chunk_tokens=MIXED_CHUNK, **BIG)
        reqs, lr, first = _serve_inline(srv, prompts, MIXED_NEW,
                                        long_prompt, MIXED_LONG_NEW)
        check(not srv.errors, f"mixed={mixed} inline: {srv.errors}")
        check(srv.prefill_chunks_total == (
            sum(len(_chunk_buckets(len(p), MIXED_CHUNK))
                for p in prompts + [long_prompt] if len(p) > MIXED_CHUNK)
            if mixed else 0), f"mixed={mixed}: {srv.prefill_chunks_total} "
            "chunks")
        inline[mixed] = ([r.tokens for r in reqs], lr.tokens, first,
                         srv.mixed_passes)
        srv.stop()
        del srv
        torch.cuda.empty_cache()
        runs[mixed], outs = _mixed_run(
            torch, model, prompts, long_prompt, mixed,
            f"7B {'mixed' if mixed else 'split'} + {MIXED_LONG}")
        check(outs == inline[mixed][0], f"mixed={mixed}: the threaded "
              "run's tokens differ from the inline run's")
        torch.cuda.empty_cache()
    check(inline[True][0] == inline[False][0],
          "the 7 rows' tokens differ between mixed and split dispatch")
    err = _rel_err(inline[True][2], inline[False][2])
    check(err <= 2e-2, f"long request's first-token logits: {err}")
    check(inline[True][3] > 0, "no mixed pass ran")
    return {"phase": "serve_mixed", "model": "Llama-2-7B q4_0 (phase 3's "
            "model)", "prompts": MIXED_PROMPTS, "new_tokens": MIXED_NEW,
            "long_prompt": MIXED_LONG, "long_new": MIXED_LONG_NEW,
            "chunk_tokens": MIXED_CHUNK, "mixed": runs[True],
            "split": runs[False], "rows_tokens_equal": True,
            "long_first_logits_max_rel_err": err, "tol": 2e-2,
            "long_first_logits_bit_equal": bool(torch.equal(
                inline[True][2], inline[False][2])),
            "long_leading_equal_tokens": next(
                (k for k, (a, b) in enumerate(zip(inline[True][1],
                                                   inline[False][1]))
                 if a != b), MIXED_LONG_NEW),
            "inline_mixed_passes": inline[True][3]}


def profile_mixed(torch, model):
    """One 7B mixed pass (batch 8 decoding at contexts 33..316, plus the
    last 64-token chunk of a 1,536-token prompt at offset 1472): the
    eager ``paged_step_mixed`` traced as in phase 4; then the engine's
    mixed step as one CUDA graph (``bind_mixed_step``) over copies of the
    same buffers, bit for bit against the eager step for 4 passes
    (tokens, logits, ``clast``, lengths, pools), and traced with the
    pass's host work: one copy of the chunk operands from pinned memory,
    the graph launch, the token fetch."""
    from bigdl_tpu_torch.llm.graphs import CapturedStep
    from bigdl_tpu_torch.llm.models.llama import paged_step_mixed
    from bigdl_tpu_torch.llm.serving import (bind_mixed_step, chunk_operands,
                                             prefill_operands)
    cfg, dev = model.config, model.device
    B, page, cap, bucket = 8, 16, 128, MIXED_CHUNK
    L, P = cfg.num_hidden_layers, 1 + B * 32 + MIXED_LONG // page
    shape = (L, P, cfg.num_key_value_heads, page, cfg.head_dim)
    g = torch.Generator(device=dev).manual_seed(6)
    st = {"kp": torch.randn(shape, generator=g, device=dev).to(
              model.cache_dtype),
          "vp": torch.randn(shape, generator=g, device=dev).to(
              model.cache_dtype),
          "bt": torch.zeros((B, cap), dtype=torch.int32, device=dev),
          "lens": torch.tensor([33, 73, 114, 155, 196, 236, 276, 316],
                               dtype=torch.int32, device=dev),
          "last": torch.randn((B, cfg.vocab_size), generator=g, device=dev),
          "active": torch.ones(B, dtype=torch.bool, device=dev),
          "toks": torch.zeros(B, dtype=torch.int32, device=dev),
          "ops": torch.zeros(3 * bucket + 4 + cap, dtype=torch.int32,
                             device=dev),
          "clast": torch.zeros(cfg.vocab_size, device=dev)}
    st["bt"][:, :32] = (1 + torch.arange(B * 32, device=dev)).reshape(B, 32)
    st["active"][7] = False                     # the chunking slot
    rows = list(range(1 + B * 32, P))
    ids = torch.randint(0, cfg.vocab_size, (MIXED_LONG,),
                        generator=torch.Generator().manual_seed(7)).numpy()
    ops_host = torch.from_numpy(prefill_operands(
        ids, MIXED_LONG - bucket, MIXED_LONG, bucket, rows, page=page,
        pages_cap=cap)).pin_memory()
    st["ops"].copy_(ops_host)
    e = {k: v.clone() for k, v in st.items()}

    def eager():
        t, lg, _, _, ln, cl = paged_step_mixed(
            model.params, cfg, e["kp"], e["vp"], e["bt"], e["lens"],
            e["last"], e["active"], 1.0, None,
            *chunk_operands(e["ops"], bucket, cap), page=page)
        e["last"], e["lens"] = lg, ln
        return t, cl

    captured = CapturedStep(bind_mixed_step(
        model.params, cfg, *(st[k] for k in (
            "kp", "vp", "bt", "lens", "last", "active", "toks", "ops",
            "clast")), bucket=bucket, page=page), dev)
    with torch.inference_mode():
        for i in range(4):
            captured()
            t, cl = eager()
            check(torch.equal(t, st["toks"]) and torch.equal(
                e["last"], st["last"]) and torch.equal(e["lens"], st["lens"])
                and torch.equal(cl, st["clast"]),
                f"graphed mixed pass {i} differs from the eager pass")
        check(torch.equal(e["kp"], st["kp"]) and torch.equal(e["vp"],
                                                              st["vp"]),
              "graphed mixed passes wrote other pools than the eager ones")
    row = profile(torch, lambda: eager()[0].cpu(),
                  "7B mixed pass, batch 8 + a 64-token chunk at 1472")
    del e

    def graphed():
        st["ops"].copy_(ops_host, non_blocking=True)
        captured()
        return st["toks"].cpu()

    grow = profile(torch, graphed, "7B mixed pass as one CUDA graph")
    calls = grow["host_launch_calls_by_name"]
    check(calls.get("cudaGraphLaunch") == 1 and calls.get(
        "cudaMemcpyAsync") == 2 and grow["host_launch_calls_per_step"] == 3,
        f"mixed pass host calls: {calls}")
    grow.update(graph_capture_s=captured.capture_seconds,
                graph_pool_mb=captured.pool_bytes / 2**20,
                counted_launches_per_replay=dict(captured.launches),
                dispatch_host_calls_per_pass=2)
    row["graph"] = grow
    row["graph_bit_equal_to_eager_passes"] = 4
    captured.close()
    return row


# -- phase 3c: speculative decoding and priority classes at 7B ----------------

# (a): one request whose prompt is a 24-token pattern tiled to 288 tokens,
# 128 new, drafts of up to SPEC_K - 1 a pass; alone and beside phase 3's
# first 7 prompts. (b): phase 3's 8 prompts as batch requests, 128 new
# each; after PRI_AFTER passes an interactive request of PRI_LATE tokens
SPEC_PATTERN, SPEC_PROMPT, SPEC_NEW, SPEC_K = 24, 288, 128, 8
PRI_NEW, PRI_AFTER, PRI_LATE, PRI_LATE_NEW = 128, 16, 300, 32


def _lead(a, b):
    """Leading equal tokens of ``a`` and ``b`` (the first position where
    they part, or the length when they never do)."""
    return next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def _spec_run(torch, model, prompts, spec, what):
    """Serve ``prompts`` (``SPEC_NEW`` greedy tokens each, all submitted
    at once) on a fresh server with ``spec`` on or off, by the engine's
    thread, twice: the first run is the warm-up (the decode graph and
    each draft bucket's verify graph it meets are captured there), the
    second is measured with the launch counters zeroed just before.
    Checks: no engine error, in-vocab tokens, every decode step and
    every verify pass after a bucket's first a replay of its graph (one
    capture per bucket), exact launch counts (a verify pass of bucket W
    is a decode leg plus a prefill leg at bucket W: its 129 linears on
    the GEMV and one tensor-core kernel 3 a layer). With ``spec``: drafts
    proposed and accepted, and every pass emitting ``g0`` plus its
    accepted drafts. The tokens' equality with the warm-up's is
    reported: with several rows drafting, which row verifies when
    depends on the thread's timing."""
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.serving import LLMServer
    cfg = model.config
    srv = LLMServer(model, spec=spec, spec_k=SPEC_K, **SERVE_7B).start()
    try:
        warm = [r.get(timeout=900) for r in
                [srv.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]]
        check(not srv.errors, f"{what}: engine errors: {srv.errors}")

        def snap():
            return ({"decode": (srv._decode.calls,
                                srv._decode.replays)} | {
                b: (st.calls, st.replays)
                for b, (st, _, _) in srv._spec_steps.items()},
                srv.steps, srv.spec_passes, srv.spec_proposed_total,
                srv.spec_accepted_total, srv.spec_emitted_total)
        g0, *c0 = snap()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [srv.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]
        outs = [r.get(timeout=900) for r in reqs]
        t1 = time.perf_counter()
        counts = kernels.launch_counts()
        g1, *c1 = snap()
        captured = {b: st.capture_seconds
                    for b, (st, _, _) in srv._spec_steps.items()}
    finally:
        srv.stop()
    check(not srv.errors, f"{what}: engine errors: {srv.errors}")
    steps, passes, proposed, accepted, emitted = (
        b - a for a, b in zip(c0, c1))
    calls = {k: (g1[k][0] - g0.get(k, (0, 0))[0],
                 g1[k][1] - g0.get(k, (0, 0))[1]) for k in g1}
    by_bucket = {b: c for b, (c, _) in calls.items() if b != "decode"
                 and c}
    check(calls["decode"] == (steps - passes,) * 2,
          f"{what}: decode graph calls {calls['decode']} for "
          f"{steps - passes} decode passes")
    for b in by_bucket:
        total, replays = g1[b]
        check((captured[b] is not None) == (total > 1)
              and replays == total - 1,
              f"{what}: bucket {b}: {total} calls, {replays} replays")
    for i, toks in enumerate(outs):
        check(len(toks) == SPEC_NEW and all(0 <= t < cfg.vocab_size
                                            for t in toks),
              f"{what} request {i}: tokens {toks}")
    buckets = [_bucket(len(p)) for p in prompts] + [
        b for b, c in by_bucket.items() for _ in range(c)]
    expect = _path_expect(model, buckets, steps)
    check(counts == expect, f"{what}: launch counts {counts} != {expect}")
    if spec:
        check(passes > 0 and accepted > 0, f"{what}: {passes} verify "
              f"passes, {accepted} drafts accepted")
        check(emitted == passes + accepted, f"{what}: emitted {emitted} "
              f"!= passes {passes} + accepted {accepted}")
    else:
        check(passes == 0 and not by_bucket, f"{what}: verify passes")
    r = reqs[-1]                                   # the pattern request
    return {"what": what, "spec": spec, "requests": len(prompts),
            "prompt_lens": [len(p) for p in prompts], "new": SPEC_NEW,
            "launches": counts, "passes": steps,
            "verify_passes": passes, "verify_passes_by_bucket": by_bucket,
            "decode_passes": steps - passes,
            "drafts_proposed": proposed, "drafts_accepted": accepted,
            "tokens_emitted_by_verify": emitted,
            "acceptance_rate": accepted / proposed if proposed else None,
            "spec_row_ttft_ms": (r.t_first_token - r.t_submit) * 1e3,
            "spec_row_tok_per_s": (len(r.tokens) - 1)
            / (r.t_tokens[-1] - r.t_first_token),
            "aggregate_tok_per_s": sum(map(len, outs)) / (t1 - t0),
            "wall_s": t1 - t0,
            "graph_capture_s": {b: captured[b] for b in by_bucket},
            "tokens_equal_to_warm_up": outs == warm,
            "spec_row_tokens": outs[-1]}, outs


def serve_spec(torch, model):
    """(a) the pattern request served alone and beside phase 3's first 7
    prompts, with ``spec=True`` and ``spec=False``: tok/s of the spec row
    and in all, passes by bucket, drafts proposed / accepted / emitted,
    and how far the spec row's tokens match the spec-off engine's."""
    cfg = model.config
    gen = torch.Generator().manual_seed(9)
    pattern = torch.randint(0, cfg.vocab_size, (SPEC_PATTERN,),
                            generator=gen)
    sp = pattern.repeat(SPEC_PROMPT // SPEC_PATTERN).numpy()
    others = _phase3_prompts(torch, cfg)[:7]
    out = {}
    for name, prompts in (("alone", [sp]), ("beside 7", others + [sp])):
        for spec in (False, True):
            row, outs = _spec_run(
                torch, model, prompts, spec,
                f"7B spec {'on' if spec else 'off'} {name}")
            out[(name, spec)] = (row, outs)
            torch.cuda.empty_cache()
    res = {"phase": "serve_spec", "model": "Llama-2-7B q4_0 (phase 3's "
           "model)", "pattern_tokens": SPEC_PATTERN, "prompt": SPEC_PROMPT,
           "new": SPEC_NEW, "spec_k": SPEC_K}
    for name in ("alone", "beside 7"):
        on, off = out[(name, True)], out[(name, False)]
        res[name] = {"on": on[0], "off": off[0],
                     "spec_row_leading_equal_tokens": _lead(on[1][-1],
                                                            off[1][-1]),
                     "others_leading_equal_tokens": [
                         _lead(a, b) for a, b in zip(on[1][:-1],
                                                     off[1][:-1])]}
    return res


def profile_spec(torch, model):
    """One 7B verify pass (batch 8 at contexts 33..316, row 7 verifying 7
    drafts at its length, bucket 8): the eager ``paged_step_spec`` traced
    as in phase 4; then the engine's verify step as one CUDA graph
    (``bind_spec_step``) over copies of the same buffers, bit for bit
    against the eager step for 4 passes (ids, ``n_acc``, logits, lengths,
    every real page), and traced with the pass's host work: one copy of the
    operands from pinned memory, the graph launch, the fetch."""
    from bigdl_tpu_torch.llm.graphs import CapturedStep
    from bigdl_tpu_torch.llm.models.llama import paged_step_spec
    from bigdl_tpu_torch.llm.serving import (bind_spec_step, spec_operands,
                                             verify_operands)
    cfg, dev = model.config, model.device
    B, page, cap, bucket, srow = 8, 16, 32, 8, 7
    L, P = cfg.num_hidden_layers, 1 + B * cap
    shape = (L, P, cfg.num_key_value_heads, page, cfg.head_dim)
    g = torch.Generator(device=dev).manual_seed(10)
    st = {"kp": torch.randn(shape, generator=g, device=dev).to(
              model.cache_dtype),
          "vp": torch.randn(shape, generator=g, device=dev).to(
              model.cache_dtype),
          "bt": (1 + torch.arange(B * cap, device=dev)).reshape(B, cap).to(
              torch.int32),
          "lens": torch.tensor([33, 73, 114, 155, 196, 236, 276, 316],
                               dtype=torch.int32, device=dev),
          "last": torch.randn((B, cfg.vocab_size), generator=g, device=dev),
          "active": torch.ones(B, dtype=torch.bool, device=dev),
          "sout": torch.zeros(B + 1 + bucket, dtype=torch.int32, device=dev),
          "ops": torch.zeros(2 + 3 * bucket + cap, dtype=torch.int32,
                             device=dev)}
    st["active"][srow] = False                  # the verify row sits out
    bt_row = st["bt"][srow].cpu().numpy()
    e = {k: v.clone() for k, v in st.items()}

    def ops_now():
        tok = int(e["last"][srow].argmax())
        return torch.from_numpy(verify_operands(
            srow, [tok] * (bucket - 1), int(e["lens"][srow]), bucket,
            bt_row, page=page)).pin_memory()

    def eager(ops):
        out, lg, _, _, ln = paged_step_spec(
            model.params, cfg, e["kp"], e["vp"], e["bt"], e["lens"],
            e["last"], e["active"], 1.0, None,
            *spec_operands(ops.to(dev), bucket, cap), page=page)
        e["last"], e["lens"] = lg, ln
        return out

    captured = CapturedStep(bind_spec_step(
        model.params, cfg, *(st[k] for k in (
            "kp", "vp", "bt", "lens", "last", "active", "sout", "ops")),
        bucket=bucket, page=page), dev)
    n_acc = []
    with torch.inference_mode():
        for i in range(4):
            ops = ops_now()
            st["ops"].copy_(ops)
            captured()
            out = eager(ops)
            check(torch.equal(out, st["sout"]) and torch.equal(
                e["last"], st["last"]) and torch.equal(e["lens"], st["lens"]),
                f"graphed verify pass {i} differs from the eager pass")
            n_acc.append(int(out[B]))
        # every real page (trash page 0 takes the dummy writes)
        check(torch.equal(e["kp"][:, 1:], st["kp"][:, 1:]) and torch.equal(
            e["vp"][:, 1:], st["vp"][:, 1:]),
            "graphed verify passes wrote other pools than the eager ones")
    # profiled at a fixed operand vector: the row's length runs ahead of
    # it, which changes no kernel's shape
    ops_host = ops_now()
    row = profile(torch, lambda: eager(ops_host).cpu(),
                  "7B verify pass, batch 8 + 7 drafts for row 7 at 316+")
    del e

    def graphed():
        st["ops"].copy_(ops_host, non_blocking=True)
        captured()
        return st["sout"].cpu()

    grow = profile(torch, graphed, "7B verify pass as one CUDA graph")
    calls = grow["host_launch_calls_by_name"]
    check(calls.get("cudaGraphLaunch") == 1 and calls.get(
        "cudaMemcpyAsync") == 2 and grow["host_launch_calls_per_step"] == 3,
        f"verify pass host calls: {calls}")
    grow.update(graph_capture_s=captured.capture_seconds,
                graph_pool_mb=captured.pool_bytes / 2**20,
                counted_launches_per_replay=dict(captured.launches),
                dispatch_host_calls_per_pass=2)
    row["graph"] = grow
    row["graph_bit_equal_to_eager_passes"] = 4
    row["n_acc_of_the_4_passes"] = n_acc
    captured.close()
    return row


def _priority_run(torch, model, batch, late, priority, what, **extra):
    """(b)'s run, driven inline (``_admit`` then ``_step_paged``, the
    engine loop's pass) so both runs see the same schedule: a warm-up
    request captures the decode graph; then the batch requests, and
    after ``PRI_AFTER`` passes the interactive one. Exact launch counts:
    every prefill leg at its bucket (the resume's at its uncached
    suffix's) and every decode step. ``extra``: more server options
    (phase 3e's host tier)."""
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.serving import LLMServer
    cfg = model.config
    srv = LLMServer(model, priority=priority, kvcache=True, **SERVE_7B,
                    **extra)
    warm = torch.randint(0, cfg.vocab_size, (20,),
                         generator=torch.Generator().manual_seed(11))
    warm[0] = 0                                   # no prompt starts so
    w = srv.submit(warm.numpy(), 4)
    while not w.done.is_set():
        srv._admit()
        srv._step_paged()
    while srv._inflight:
        srv._drain_next()
    check(srv._decode.graph is not None,
          f"{what}: the step was not captured")
    steps0, saved0 = srv.steps, srv.prefix_tokens_saved
    kernels.reset_launch_counts()
    rb = [srv.submit(p, PRI_NEW, "batch") for p in batch]
    ri, n = None, 0
    while ri is None or not all(r.done.is_set() for r in rb + [ri]):
        srv._admit()
        if ri is None and n == PRI_AFTER:
            ri = srv.submit(late, PRI_LATE_NEW, "interactive")
        srv._step_paged()
        n += 1
    while srv._inflight:
        srv._drain_next()
    counts = kernels.launch_counts()
    steps, saved = srv.steps - steps0, srv.prefix_tokens_saved - saved0
    stats = (srv.preemptions_total, srv.preempt_resumes_total)
    modes, parked = dict(srv.preempt_modes), len(srv._parked or ())
    handoff_mb = (srv._tier.handoff_bytes / 2**20
                  if srv._tier is not None else 0.0)
    srv.stop()
    check(not srv.errors, f"{what}: engine errors: {srv.errors}")
    check(srv._budget_avail == srv._num_pages - 1 and srv.pages_in_use == 0,
          f"{what}: the ledger did not come back")
    victims = [j for j, r in enumerate(rb) if r.resume_ids is not None]
    buckets = [_bucket(len(p)) for p in batch + [late]] + [
        _bucket(len(rb[j].resume_ids) - saved) for j in victims]
    check(len(victims) <= 1, f"{what}: victims {victims}")
    expect = _path_expect(model, buckets, steps)
    check(counts == expect, f"{what}: launch counts {counts} != {expect}")
    for r, k in [(r, PRI_NEW) for r in rb] + [(ri, PRI_LATE_NEW)]:
        check(len(r.tokens) == k and all(0 <= t < cfg.vocab_size
                                         for t in r.tokens),
              f"{what}: tokens {r.tokens}")
    gaps = {j: max(b - a for a, b in zip(r.t_tokens, r.t_tokens[1:]))
            for j, r in enumerate(rb)}
    return {"what": what, "priority": priority, "launches": counts,
            "passes": steps, "preemptions_total": stats[0],
            "preempt_resumes_total": stats[1], "preempt_modes": modes,
            "parked_blobs_left": parked, "exported_mb": handoff_mb,
            "victims": victims,
            "resume_tokens_reused": saved,
            "resume_prefill_buckets": buckets[len(batch) + 1:],
            "interactive_ttft_ms": (ri.t_first_token - ri.t_submit) * 1e3,
            "batch_max_gap_ms": {j: v * 1e3 for j, v in gaps.items()},
            "batch_median_gap_ms": statistics.median(
                b - a for r in rb for a, b in zip(r.t_tokens,
                                                  r.t_tokens[1:])) * 1e3
            }, rb, ri


def serve_priority(torch, model):
    """(b) 8 batch requests (phase 3's prompts, 128 new each) decoding;
    after 16 passes an interactive request of 300 tokens (32 new). With
    ``priority=True`` (and the prefix cache) it preempts the youngest
    batch decode (the tie goes to the highest slot), which resumes from
    its indexed chain when a slot frees; with ``priority=False`` it waits
    for a slot. The victim's tokens before the preemption must equal its
    tokens without priority; how many equal after is reported."""
    cfg = model.config
    batch = _phase3_prompts(torch, cfg)
    late = torch.randint(0, cfg.vocab_size, (PRI_LATE,),
                         generator=torch.Generator().manual_seed(12))
    late[0] = 1
    runs = {}
    for pri in (True, False):
        runs[pri] = _priority_run(torch, model, batch, late.numpy(), pri,
                                  f"7B priority {'on' if pri else 'off'}")
        torch.cuda.empty_cache()
    on, rb_on, _ = runs[True]
    off, rb_off, _ = runs[False]
    check(on["preemptions_total"] == on["preempt_resumes_total"] == 1
          and off["preemptions_total"] == 0, f"preemptions: {on}, {off}")
    v = on["victims"][0]
    k = len(rb_on[v].resume_ids) - len(batch[v])
    check(rb_on[v].tokens[:k] == rb_off[v].tokens[:k],
          "the victim's tokens before its preemption differ from its run "
          "without priority")
    return {"phase": "serve_priority", "model": "Llama-2-7B q4_0 (phase "
            "3's model)", "batch_prompts": [len(p) for p in batch],
            "batch_new": PRI_NEW, "interactive_prompt": PRI_LATE,
            "interactive_new": PRI_LATE_NEW, "arrives_after_passes":
            PRI_AFTER, "on": on, "off": off, "victim": v,
            "victim_tokens_before_preemption": k,
            "victim_tokens_on": rb_on[v].tokens,
            "victim_leading_equal_tokens": _lead(rb_on[v].tokens,
                                                 rb_off[v].tokens),
            "victim_max_gap_ms_on_off": [on["batch_max_gap_ms"][v],
                                         off["batch_max_gap_ms"][v]],
            "others_tokens_equal": [rb_on[j].tokens == rb_off[j].tokens
                                    for j in range(len(batch)) if j != v]}


# -- phase 3e: the host KV tier at 7B ------------------------------------------

# four distinct 1,024-token prefixes (64 pages, 512 MiB of K and V each at
# page 16); pass 1 sends each with one of phase 3's tails, pass 2 with a new
# tail of 1 + a page multiple (so a prompt's last token starts a page: a
# re-admission and an import then both prefill that one token over the same
# pages), 32 new tokens each, one request at a time. The pool holds about
# two of the four chains beside the live row (1,024 + 300 + 32 tokens take
# 85 pages), so pass 1 evicts the oldest prefixes, to the host arena with
# the tier on, and pass 2 takes them back
TIER_TAILS = ((17, 139, 220, 300), (33, 97, 177, 257))
TIER_NEW, TIER_NUM_PAGES, TIER_HOST_PAGES = 32, 1 + 200, 512


def _tier_prompts(torch, cfg):
    gen = torch.Generator().manual_seed(13)
    prefixes = [torch.randint(0, cfg.vocab_size, (PREFIX_TOKENS,),
                              generator=gen) for _ in range(4)]
    return [[torch.cat([pre, torch.randint(0, cfg.vocab_size, (n,),
                                           generator=gen)]).numpy()
             for pre, n in zip(prefixes, tails)] for tails in TIER_TAILS]


def _serve_one(srv, prompt, n):
    """Serve one request driven inline as the engine loop drives it
    (``_admit``, ``_step_paged``, a 2 ms sleep when idle: a fetch-parked
    admission polls its upload so). Returns the request, its first-token
    logits (``_last`` of its slot right after its prefill) and how many of
    its tokens were cached (``matched_len``: device and fetched)."""
    req = srv.submit(prompt, max_new_tokens=n)
    first = matched = None
    while not req.done.is_set():
        srv._admit()
        if first is None and req in srv._slots:
            i = srv._slots.index(req)
            first, matched = srv._last[i].clone(), srv._slot_adm[i].matched_len
        if not srv._step_paged():
            time.sleep(0.002)
    while srv._inflight:
        srv._drain_next()
    return req, first, matched


def _tier_run(torch, model, passes, tier, what):
    """Both passes on a fresh server (``BIG``, ``kvcache=True``, the pool
    of ``TIER_NUM_PAGES``) after a warm-up request that captures the
    decode graph. Checks: no engine error, in-vocab tokens, the ledger
    whole at the end (nothing pinned, the whole budget back, no arena
    pin once the migrator has drained), exact launch counts (every prefill at its uncached suffix's
    bucket); with the tier, fetches and no failed one. Returns the row,
    pass 2's requests and first-token logits, and the server (stopped by
    the caller)."""
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.serving import LLMServer
    cfg = model.config
    srv = LLMServer(model, kvcache=True, kvtier=tier,
                    host_pages=TIER_HOST_PAGES, num_pages=TIER_NUM_PAGES,
                    **BIG)
    warm = torch.randint(0, cfg.vocab_size, (20,),
                         generator=torch.Generator().manual_seed(14))
    warm[0] = 0
    _serve_one(srv, warm.numpy(), 4)
    check(srv._decode.graph is not None, f"{what}: the step was not captured")
    steps0 = srv.steps
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    runs = [[_serve_one(srv, p, TIER_NEW) for p in ps] for ps in passes]
    counts = kernels.launch_counts()
    steps = srv.steps - steps0
    peak = torch.cuda.max_memory_allocated()
    if tier:
        # the last request's spills run on the migrator's thread after it
        # finishes: the ledger is read once they have landed
        check(srv._tier.migrator.drain(),
              f"{what}: a migration did not finish in 30 s")
    st = srv._kv.debug_stats()
    check(not srv.errors, f"{what}: engine errors: {srv.errors}")
    check(st["pages_pinned"] == 0 and st["budget_avail"] ==
          TIER_NUM_PAGES - 1 and srv.pages_in_use == 0,
          f"{what}: the ledger did not come back: {st}")
    buckets = [_bucket(len(r.prompt_ids) - m) for run in runs
               for r, _, m in run]
    expect = _path_expect(model, buckets, steps)
    check(counts == expect, f"{what}: launch counts {counts} != {expect}")
    for r, _, _ in runs[0] + runs[1]:
        check(len(r.tokens) == TIER_NEW and all(
            0 <= t < cfg.vocab_size for t in r.tokens),
            f"{what}: tokens {r.tokens}")
    ttft1, ttft2 = ([(r.t_first_token - r.t_submit) * 1e3 for r, _, _ in run]
                    for run in runs)
    row = {"what": what, "kvtier": tier, "launches": counts,
           "decode_steps": steps, "prefill_buckets": buckets,
           "pass2_cached_tokens": [m for _, _, m in runs[1]],
           "pass2_ttft_ms": ttft2,
           "pass2_ttft_ms_mean": statistics.mean(ttft2),
           "pass1_ttft_ms": ttft1, "pass1_ttft_ms_mean": statistics.mean(ttft1),
           "prefix_tokens_reused": st["prefix_tokens_reused"],
           "evictions": st["evictions"],
           "pool_gb": 2 * srv._k_pages.nbytes / 1e9,
           "peak_mem_gb": peak / 1e9}
    if tier:
        t, mig = st["tier"], srv._tier.migrator
        check(t["fetches"] > 0 and t["fetch_failures"] == 0
              and t["spill_failures"] == 0 and t["pinned"] == 0,
              f"{what}: tier {t}")
        row.update({
            "spills": t["spills"], "fetches": t["fetches"],
            "fetch_failures": t["fetch_failures"],
            "spill_failures": t["spill_failures"],
            "fetch_wait_ms_mean": srv.fetch_wait_seconds
            / max(srv.fetch_waits, 1) * 1e3,
            "fetch_transfer_ms_total": mig.fetch_seconds * 1e3,
            "fetch_mb_per_s": (mig.fetch_bytes / mig.fetch_seconds / 1e6
                               if mig.fetch_seconds else None),
            "arena_pinned_mb": srv._tier.arena.pinned_bytes / 2**20,
            "arena_alloc_s": srv._tier.arena.alloc_seconds,
            "spills_done": mig.spills_done,
            "arena": {k: t[k] for k in ("capacity", "used", "ready",
                                        "evictions", "bytes_used")}})
    else:
        check("tier" not in st, f"{what}: a tier without kvtier")
        row.update({"spills": 0, "fetches": 0, "fetch_failures": 0})
    return row, runs[1], srv


def _copy_rates(torch):
    """The card's host<->device copy rate from page-locked memory, GB/s
    (CUDA events, median of 5): one 512 MiB copy each way (a fetch's
    bytes), and the same bytes as 128 copies of 4 MiB on a side stream
    (a fetch's uploads: one K and one V page a chunk)."""
    dev = torch.device("cuda")
    n = 512 * 2**20
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(n, dtype=torch.uint8, device=dev)
    side = torch.cuda.Stream(dev)

    def rate(fn, stream=None):
        out = []
        for _ in range(5):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with torch.cuda.stream(stream or torch.cuda.current_stream()):
                a.record()
                fn()
                b.record()
            b.synchronize()
            out.append(n / (a.elapsed_time(b) / 1e3) / 1e9)
        return statistics.median(out)

    piece = n // 128
    res = {"h2d_gb_s": rate(lambda: card.copy_(host, non_blocking=True)),
           "d2h_gb_s": rate(lambda: host.copy_(card, non_blocking=True)),
           "h2d_4mib_pieces_side_stream_gb_s": rate(lambda: [
               card[j * piece:(j + 1) * piece].copy_(
                   host[j * piece:(j + 1) * piece], non_blocking=True)
               for j in range(128)], side)}
    del host, card
    return res


def _handoff(torch, model, exporter, prompt):
    """A warm chain from the tier-on server into a second server on the
    same model: ``import_chain(export_chain(prompt))``, then ``prompt``
    admitted from the importer's arena. Its first-token logits against
    the exporter's own re-admission of ``prompt`` (both prefill its last
    token over the same page bytes)."""
    from bigdl_tpu_torch.llm.serving import LLMServer
    t0 = time.perf_counter()
    blob = exporter.export_chain(prompt)
    export_ms = (time.perf_counter() - t0) * 1e3
    _, want, m_exp = _serve_one(exporter, prompt, 2)
    imp = LLMServer(model, kvcache=True, kvtier=True, host_pages=128,
                    num_pages=TIER_NUM_PAGES, **BIG)
    try:
        t0 = time.perf_counter()
        n = imp.import_chain(blob)
        import_ms = (time.perf_counter() - t0) * 1e3
        req, got, m_imp = _serve_one(imp, prompt, 2)
        fetches, alloc_s = imp._tier.fetches, imp._tier.arena.alloc_seconds
        check(not imp.errors, f"handoff importer errors: {imp.errors}")
    finally:
        imp.stop()
    full = len(prompt) // 16
    check(n == full and fetches == len(prompt) // 16 and m_imp == m_exp
          == len(prompt) - 1, f"handoff: imported {n} of {full} pages, "
          f"fetched {fetches}, cached {m_imp} / {m_exp} tokens")
    err = (got - want).abs().max().item()
    rel = _rel_err(got, want)
    check(rel <= 2e-2, f"handoff: first-token logits rel err {rel}")
    return {"pages": n, "blob_mb": len(blob) / 2**20,
            "export_ms": export_ms, "import_ms": import_ms,
            "importer_arena_alloc_s": alloc_s,
            "cached_tokens": m_imp, "first_logits_max_abs_diff": err,
            "first_logits_rel_err": rel, "tol": 2e-2,
            "first_logits_bit_equal": bool(torch.equal(got, want))}


def serve_kvtier(torch, model, pri):
    """Phase 3e: the two passes with the tier off and on, the handoff of
    the last pass-2 chain into a second server, and phase 3c's priority
    scenario again with the tier on (the victim's chain parked
    "exported"; its tokens equal to phase 3c's run without the tier)."""
    cfg = model.config
    passes = _tier_prompts(torch, cfg)
    rows, firsts = {}, {}
    for tier in (False, True):
        what = f"7B kvtier {'on' if tier else 'off'}"
        row, pass2, srv = _tier_run(torch, model, passes, tier, what)
        if tier:
            row["handoff"] = _handoff(torch, model, srv, passes[1][-1])
        srv.stop()
        del srv
        torch.cuda.empty_cache()
        rows[tier], firsts[tier] = row, pass2
    errs = [_rel_err(a[1], b[1]) for a, b in zip(firsts[True],
                                                  firsts[False])]
    check(max(errs) <= 2e-2, f"kvtier: pass-2 first-token logits {errs}")
    batch = _phase3_prompts(torch, cfg)
    late = torch.randint(0, cfg.vocab_size, (PRI_LATE,),
                         generator=torch.Generator().manual_seed(12))
    late[0] = 1
    pre, rb, _ = _priority_run(torch, model, batch, late.numpy(), True,
                               "7B priority kvtier", kvtier=True,
                               host_pages=128)
    torch.cuda.empty_cache()
    v = pri["victim"]
    check(pre["victims"] == [v] and pre["preempt_modes"]["exported"] == 1
          and pre["parked_blobs_left"] == 0,
          f"kvtier preemption: {pre['victims']} {pre['preempt_modes']}")
    check(rb[v].tokens == pri["victim_tokens_on"],
          "kvtier preemption: the victim's tokens differ from phase 3c's")
    return {"phase": "serve_kvtier", "model": "Llama-2-7B q4_0 (phase 3's "
            "model)", "prefix_tokens": PREFIX_TOKENS, "tails": TIER_TAILS,
            "new_tokens": TIER_NEW, "num_pages": TIER_NUM_PAGES,
            "host_pages": TIER_HOST_PAGES, "on": rows[True],
            "off": rows[False], "pass2_first_logits_max_rel_err": errs,
            "tol": 2e-2, "pass2_tokens_equal": [
                a[0].tokens == b[0].tokens for a, b in zip(firsts[True],
                                                           firsts[False])],
            "pass2_leading_equal_tokens": [
                _lead(a[0].tokens, b[0].tokens)
                for a, b in zip(firsts[True], firsts[False])],
            "priority": pre, "victim": v,
            "victim_tokens_equal_phase_3c": True,
            "copy_rates": _copy_rates(torch)}


def _family(name):
    """Phase 10's families at full width: ``name`` → (config, model
    class)."""
    from bigdl_tpu_torch.llm.models import (BloomConfig, BloomForCausalLM,
                                            GptNeoXConfig, GptNeoXForCausalLM,
                                            StarCoderConfig,
                                            StarCoderForCausalLM)
    return {"StarCoder-15B": (StarCoderConfig.starcoder_15b(),
                              StarCoderForCausalLM),
            "GPT-NeoX-20B": (GptNeoXConfig(), GptNeoXForCausalLM),
            "Bloom-7b1": (BloomConfig.bloom_7b1(), BloomForCausalLM)}[name]


def reference_check(torch, dev, preset="llama2_7b", moe_factor=None):
    """The served path on the card against the port's plain path on the
    CPU, on a small input: the ``preset``'s model (Llama-2-7B, or
    GLM-4-9B with its group of 16) at full width cut to 2 layers, the
    same synthetic q4_0 weights on both devices, one ragged prefill of a
    40-token prompt (on the tensor cores, counted) and one paged decode
    step (the same token fed to both). Logits must agree to 2e-2 of
    their largest magnitude: both sides run bf16 activations and f32
    accumulation, and differ only where bf16 rounds a value that the
    other side's f32 sums put a hair across a rounding boundary, or
    where the card rounds P to bf16 in the prefill attention. With
    ``moe_factor`` (Mixtral-8x7B): random bf16 weights at that expert
    capacity factor, and a 12-token prompt (the CPU runs the experts in
    bf16). A phase 10 family (``preset`` "StarCoder-15B", "GPT-NeoX-20B"
    or "Bloom-7b1"): random q4_0 weights drawn on the card and the
    family's own prefill and decode step; Bloom's dense ``forward``
    (prefill and one decode token, no attention kernel)."""
    import dataclasses
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.models.llama import (LlamaConfig,
                                                  LlamaForCausalLM,
                                                  init_params,
                                                  paged_prefill_ragged)
    from bigdl_tpu_torch.llm.serving import paged_decode_step

    page, T, bucket = 16, 40, 64
    if preset in FAMILIES:
        cfg0, cls = _family(preset)
        cfg = dataclasses.replace(cfg0, num_hidden_layers=2)
        gpu = cls.from_config(cfg, seed=3, load_in_low_bit="sym_int4",
                              device=dev)
        fam = sys.modules[cls.__module__]
        paged_prefill_ragged = getattr(fam, "paged_prefill_ragged", None)
        paged_decode_step = getattr(fam, "paged_decode_step", None)
    else:
        cfg = dataclasses.replace(getattr(LlamaConfig, preset)(),
                                  num_hidden_layers=2)
        cls = LlamaForCausalLM
        if moe_factor is None:
            gpu = LlamaForCausalLM.synthetic_q4(cfg, device=dev, seed=3)
        else:
            cfg = dataclasses.replace(cfg, expert_capacity_factor=moe_factor)
            gpu = LlamaForCausalLM(cfg, init_params(cfg, 3, device=dev),
                                   device=dev)
            T, bucket = 12, 16
    cpu = cls(cfg, gpu.params, device="cpu")
    paged = paged_decode_step is not None
    prompt = torch.randint(0, cfg.vocab_size, (1, bucket),
                           generator=torch.Generator().manual_seed(2))
    bt_row = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    pos = torch.arange(bucket)
    phys = torch.where(pos < T, bt_row[(pos // page).clamp(max=3)],
                       torch.zeros_like(pos)).to(torch.int32)
    slots = (pos % page).to(torch.int32)
    out, tok, counts = {}, None, {}
    for name, m in (("gpu", gpu), ("cpu", cpu)):
        d = m.device
        kernels.reset_launch_counts()
        shape = (cfg.num_hidden_layers, 6, cfg.num_key_value_heads, page,
                 cfg.head_dim)
        kp = torch.zeros(shape, dtype=m.cache_dtype, device=d)
        vp = torch.zeros(shape, dtype=m.cache_dtype, device=d)
        with torch.inference_mode():
            if paged:
                kp, vp, last = paged_prefill_ragged(
                    m.params, cfg, kp, vp, prompt.to(d), T, 0, bt_row.to(d),
                    phys.to(d), slots.to(d), 0, 0, page=page)
            else:
                full, cache = m(prompt[:, :T])
                last = full[0, -1]
            if tok is None:
                tok = int(last.argmax())
            if paged:
                logits = paged_decode_step(
                    m.params, cfg, kp, vp, bt_row[None].to(d),
                    torch.tensor([T], dtype=torch.int32, device=d),
                    torch.tensor([tok], device=d), page=page)[0]
            else:
                logits = m([[tok]], cache)[0][:, 0]
        out[name] = (last.float().cpu(), logits[0].float().cpu())
        counts[name] = kernels.launch_counts()
    L = cfg.num_hidden_layers
    check(counts["gpu"]["ragged_prefill_attention_tc"] == L * paged
          and counts["gpu"]["paged_attention_decode_stats"] == L * paged
          and not any(counts["cpu"].values()),
          f"reference check launches: {counts}")
    errs = {}
    for i, what in enumerate(("prefill", "decode")):
        g, c = out["gpu"][i], out["cpu"][i]
        check(bool(torch.isfinite(g).all()), f"{what} logits not finite")
        errs[what] = ((g - c).abs().max() / c.abs().max()).item()
    tol = 2e-2
    check(max(errs.values()) <= tol, f"card vs CPU logits: {errs}")
    return {"phase": "reference", "model": f"{preset} width (Hq "
            f"{cfg.num_attention_heads} / Hkv {cfg.num_key_value_heads}), "
            "2 layers, " + ("random bf16 weights quantized to q4_0 on the "
                            "card" if preset in FAMILIES else
                            "synthetic q4_0" if moe_factor is None else
                            f"bf16, expert capacity factor {moe_factor}"),
            "prompt_tokens": T,
            "card_launches": counts["gpu"],
            "max_rel_err_logits": errs, "tol": tol, "passed": True}


# the host's calls that put work on the card's queue: one per kernel when
# eager, one cudaGraphLaunch per replayed step
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemsetAsync", "cudaMemcpyAsync")


def profile(torch, step, what, steps=3):
    """Where one ``step()`` call's time goes: its host-clock wall time
    (median of 5; ``step`` ends in a fetch to the host), then a
    ``torch.profiler`` trace of ``steps`` calls (CUDA kernel intervals:
    device busy time, kernel launches, time by kernel; and the host's
    launch calls, which a graph replay folds into one)."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile as trace

    with torch.inference_mode():
        for _ in range(2):
            step()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t0) * 1e3)
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
    cuda_t = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.events() if e.device_type == cuda_t]
    by_name = {}
    for e in kern:
        n = e.name if len(e.name) < 60 else e.name[:57] + "..."
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    busy = sum(t for t, _ in by_name.values()) / steps
    wall = statistics.median(walls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    host = Counter(e.name for e in prof.events()
                   if e.device_type != cuda_t and e.name in HOST_LAUNCH_CALLS)
    return {"phase": "profile", "what": what, "step_wall_ms": wall,
            "step_walls_ms": walls,
            "device_busy_ms": busy if kern else None,
            "device_idle_share": (1 - busy / wall) if kern else None,
            "kernel_launches_per_step": len(kern) / steps,
            "host_launch_calls_per_step": sum(host.values()) / steps,
            "host_launch_calls_by_name": {n: c / steps
                                          for n, c in host.items()},
            "top_kernels_ms_per_step": {n: [t / steps, c / steps]
                                        for n, (t, c) in top}}


def profile_graphed(torch, captured, fetch, what):
    """:func:`profile` of a ``CapturedStep`` (each call followed by the
    fetch of its tokens): its first warm-up call runs eagerly, the second
    captures, every timed and traced call is a replay. Adds the capture's
    seconds, the graph pool's bytes and the kernels one replay launches
    by counter."""
    row = profile(torch, lambda: (captured(), fetch()), what)
    check(captured.graph is not None and captured.replays >= 8,
          f"{what}: the step did not run as a captured graph")
    row.update(graph_capture_s=captured.capture_seconds,
               graph_pool_mb=captured.pool_bytes / 2**20,
               counted_launches_per_replay=dict(captured.launches))
    return row


def profile_decode(torch, model, label="7B"):
    """A batch-8 decode step: the engine's own step function (the sampled
    step ``family_steps`` gives ``LLMServer``) on a mid-decode state, to
    the token fetch; then the same step as the engine runs it, one
    captured CUDA graph (``bind_decode_step``), held bit for bit against
    the eager step and profiled beside it."""
    from bigdl_tpu_torch.llm.graphs import CapturedStep
    from bigdl_tpu_torch.llm.serving import bind_decode_step, family_steps

    paged_decode_step_sampled = family_steps(model)["sampled_step"]
    cfg, dev = model.config, model.device
    B, page, cap = 8, 16, 32
    L, P = cfg.num_hidden_layers, 1 + B * cap
    shape = (L, P, cfg.num_key_value_heads, page, cfg.head_dim)
    kp = torch.zeros(shape, dtype=model.cache_dtype, device=dev)
    vp = torch.zeros(shape, dtype=model.cache_dtype, device=dev)
    bt = (1 + torch.arange(B * cap, device=dev)).reshape(B, cap).to(
        torch.int32)
    lens = torch.tensor([33, 73, 114, 155, 196, 236, 276, 316],
                        dtype=torch.int32, device=dev)
    last = torch.randn((B, cfg.vocab_size), device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)

    def step():
        toks = paged_decode_step_sampled(model.params, cfg, kp, vp, bt, lens,
                                         last, active, page=page)[0]
        return toks.cpu()

    row = profile(torch, step, f"{label} decode step, batch 8, lens 33..316")

    # the engine's step as one CUDA graph, over copies of the same buffers:
    # bit for bit against the eager step for 4 steps (warm-up, capture,
    # replays), then profiled the same way
    toks = torch.zeros(B, dtype=torch.int32, device=dev)
    st = {"kp": kp, "vp": vp, "bt": bt, "lens": lens, "last": last,
          "active": active, "toks": toks}
    g = {k: v.clone() for k, v in st.items()}
    e = {k: v.clone() for k, v in st.items()}
    del st, kp, vp
    captured = CapturedStep(bind_decode_step(
        model.params, cfg, *(g[k] for k in (
            "kp", "vp", "bt", "lens", "last", "active", "toks")),
        page=page, fam_step=paged_decode_step_sampled), dev)
    with torch.inference_mode():
        for i in range(4):
            captured()
            t, lg, _, _, ln = paged_decode_step_sampled(
                model.params, cfg, e["kp"], e["vp"], e["bt"], e["lens"],
                e["last"], e["active"], page=page)
            e["last"], e["lens"] = lg, ln
            check(torch.equal(t, g["toks"]) and torch.equal(lg, g["last"])
                  and torch.equal(ln, g["lens"]),
                  f"graphed {label} step {i} differs from the eager step")
        check(torch.equal(e["kp"], g["kp"]) and torch.equal(e["vp"], g["vp"]),
              f"graphed {label} steps wrote other pools than the eager "
              "steps")
    del e
    row["graph"] = profile_graphed(
        torch, captured, lambda: g["toks"].cpu(),
        f"{label} decode step as one CUDA graph, batch 8, lens 33..")
    row["graph_bit_equal_to_eager_steps"] = 4
    captured.close()
    return row


# -- phase 6: generate() on Mistral-7B ----------------------------------------

# (batch, prompt tokens, new tokens, max_cache_len) of the two generate
# runs, and the checkpoint's config.json: Mistral-7B-v0.1's, cut to 2
# layers
GEN_A = (4, 512, 64, 1024)
GEN_B = (1, 4200, 32, 4352)
CKPT = {"model_type": "mistral", "architectures": ["MistralForCausalLM"],
        "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
        "num_hidden_layers": 2, "num_attention_heads": 32,
        "num_key_value_heads": 8, "max_position_embeddings": 8192,
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "sliding_window": 4096,
        "tie_word_embeddings": False}

def _launch_expect(counts, model, rows, n, paged):
    """What one ``generate`` of ``n`` new tokens must launch: every
    q4_0 decoder linear (4 a layer in a llama model, 6 in a family's;
    none in a bf16 model) at the prefill
    and at each of the n steps, the prefill's (``rows`` = batch x
    prompt) on the route the rule gives its shapes, and with paged
    decode one stats kernel a layer a step; the dense ``lm_head``
    launches nothing."""
    from bigdl_tpu_torch.llm.kernels import matmul_route
    L = model.config.num_hidden_layers
    layers = model.params["layers"]
    qs = [k for k, lp in layers.items() if isinstance(lp, dict)
          and "q" in lp]
    want = dict.fromkeys(counts, 0)
    want["int4_matmul"] = len(qs) * L * (1 + n)
    want["int4_matmul_tc"] = L * sum(
        matmul_route(rows, layers[k]["q"].shape[-1]) == "tc" for k in qs)
    want["int4_matmul_gemv"] = want["int4_matmul"] - want["int4_matmul_tc"]
    if paged:
        want["paged_attention_decode_stats"] = L * n
    return want


def _generate_run(torch, model, ids, n, what):
    """One ``generate`` with the counters zeroed just before: exact
    launch counts, in-vocab tokens, wall time, peak memory. The prompt's
    prefill is timed alone just before (the same call generate makes
    first); decode tok/s = B·n / (generate wall - that prefill)."""
    from bigdl_tpu_torch.llm import kernels
    cfg = model.config
    B, T = ids.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model(ids)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    del logits, cache
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=n)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = _launch_expect(counts, model, B * T, n, model.paged_decode)
    check(counts == want, f"generate {what}: launch counts {counts} != "
          f"{want}")
    new = out[:, T:]
    check(new.shape == (B, n) and bool(((new >= 0)
                                        & (new < cfg.vocab_size)).all()),
          f"generate {what}: tokens {new.shape} out of vocab")
    return {"what": what, "batch": B, "prompt_tokens": T,
            "new_tokens": n, "max_cache_len": model.max_cache_len,
            "paged_decode": model.paged_decode, "launches": counts,
            "prefill_s": prefill_s, "generate_s": wall,
            "decode_tok_per_s": B * n / (wall - prefill_s),
            "decode_step_ms": (wall - prefill_s) / n * 1e3,
            "peak_mem_gb": peak / 1e9,
            "tokens_row0": new[0].tolist()}, out


def _loop_profile(torch, model, kp, vp, bt, pos, last, what):
    """:func:`profile_graphed` of ``generate``'s paged token step
    (``PagedDecodeLoop``, greedy) over copies of a prefilled pool, from
    position ``pos`` and logits ``last``."""
    from bigdl_tpu_torch.llm.models.llama import PagedDecodeLoop
    kp2, vp2 = kp.clone(), vp.clone()
    loop = PagedDecodeLoop(model.params, model.config, kp2, vp2, bt, pos,
                           last, None, 1.0, page=model.page_size)
    with torch.no_grad():
        row = profile_graphed(torch, loop.step, lambda: loop.tok.cpu(), what)
    loop.close()
    return row


def generate_phase(torch, dev):
    """bigdl-llm's entry point on Mistral-7B q4_0 at full width and all
    32 layers: ``AutoModelForCausalLM.from_pretrained(LlamaConfig.
    mistral_7b(), load_in_4bit=True)`` (random bf16 weights from seed 0
    made on the card, quantized there; lm_head dense), then
    (a) batch 4 x 512-token prompts, 64 new tokens, max_cache_len 1024
        (single-block dense prefill attention), paged decode; then the
        same with ``paged_decode=False`` — its first decode step's logits
        against the paged step's (2e-2 of their largest magnitude) and
        how many leading greedy tokens agree (reported only);
    (b) batch 1 x 4200-token prompt, 32 new tokens, max_cache_len 4352
        (blockwise prefill attention; the 4096 window bites), and on its
        prefill pools, per layer, kernel 6 (``paged_attention()`` over
        4200 tokens) against stats over 4199 + the merge of token 4199,
        and against the plain version (1e-3, f32 q).
    Then a profile of one decode step of (a)."""
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.kernels.paged_attention import (
        merge_attention_partial, paged_attention, paged_attention_reference,
        paged_attention_stats)
    from bigdl_tpu_torch.llm.models.llama import (LlamaConfig,
                                                  LlamaForCausalLM, forward,
                                                  pageify_cache)
    from bigdl_tpu_torch.llm.serving import paged_decode_step
    from bigdl_tpu_torch.llm.transformers import AutoModelForCausalLM

    cfg = LlamaConfig.mistral_7b()
    L, page = cfg.num_hidden_layers, 16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = AutoModelForCausalLM.from_pretrained(
        cfg, load_in_4bit=True, max_cache_len=1024, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(model.params))
    rows = {}
    hgen = torch.Generator().manual_seed(11)

    # (a): the first decode step, paged against dense, on one prefill
    B, T, n, _ = GEN_A
    ids_a = torch.randint(0, cfg.vocab_size, (B, T), generator=hgen).numpy()
    with torch.no_grad():
        logits, cache = model(ids_a)
        tok0 = logits[:, -1].argmax(-1).to(torch.int32)
        kp, vp, bt = pageify_cache(cache, page=page)
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        lg_paged = paged_decode_step(model.params, cfg, kp, vp, bt, lens,
                                     tok0, page=page)[0]
        lg_dense = forward(model.params, cfg, tok0[:, None], cache,
                           torch.full((B, 1), T, dtype=torch.int32,
                                      device=dev))[0][:, 0]
    step_err = ((lg_paged - lg_dense).abs().max()
                / lg_dense.abs().max()).item()
    check(step_err <= 2e-2, f"first decode step, paged vs dense logits: "
          f"rel err {step_err}")
    del logits, cache, lg_paged, lg_dense
    rows["a"], out_a = _generate_run(torch, model, ids_a, n, "(a)")
    model.paged_decode = False
    rows["a_dense"], out_d = _generate_run(torch, model, ids_a, n,
                                           "(a) dense decode")
    model.paged_decode = True
    agree = [int(next((i for i in range(n) if out_a[r, T + i]
                       != out_d[r, T + i]), n)) for r in range(B)]
    rows["a_dense"].update(first_step_rel_err=step_err, tol=2e-2,
                           leading_tokens_equal_to_paged=agree)
    prof = profile(torch, lambda: paged_decode_step(
        model.params, cfg, kp, vp, bt, lens, tok0, page=page)[0]
        .argmax(-1).cpu(), f"Mistral-7B decode step (paged), batch {B}, "
        f"context {T}")
    with torch.no_grad():
        lg0 = paged_decode_step(model.params, cfg, kp, vp, bt, lens, tok0,
                                page=page)[0]
    prof["graph"] = _loop_profile(
        torch, model, kp, vp, bt, T, lg0,
        f"Mistral-7B generate's decode step as one CUDA graph, batch {B}, "
        f"context {T}..")
    del kp, vp, bt, lg0

    # (b): a long prompt, and kernel 6 on its prefill pools
    B, T, n, cache_len = GEN_B
    long_model = LlamaForCausalLM(cfg, model.params,
                                  max_cache_len=cache_len, device=dev)
    ids_b = torch.randint(0, cfg.vocab_size, (B, T), generator=hgen).numpy()
    qgen = torch.Generator(device=dev).manual_seed(12)
    with torch.no_grad():
        _, cache = long_model(ids_b)
        kp, vp, bt = pageify_cache(cache, page=page)
        win = cfg.sliding_window
        qs = [torch.randn((B, cfg.num_attention_heads, cfg.head_dim),
                          generator=qgen, device=dev) for _ in range(L)]
        n_all = torch.full((B,), T, dtype=torch.int32, device=dev)
        kernels.reset_launch_counts()
        outs = [paged_attention(qs[l], kp[l], vp[l], bt, n_all, page,
                                sliding_window=win) for l in range(L)]
        pa_counts = kernels.launch_counts()
        errs_merge, errs_plain = [], []
        for l in range(L):
            st = paged_attention_stats(qs[l], kp[l], vp[l], bt, n_all - 1,
                                       page, sliding_window=win - 1)
            merged = merge_attention_partial(
                *st, qs[l], cache["k"][l, :, T - 1], cache["v"][l, :, T - 1])
            plain = paged_attention_reference(qs[l], kp[l], vp[l], bt,
                                              n_all, sliding_window=win)
            errs_merge.append((outs[l] - merged).abs().max().item())
            errs_plain.append((outs[l] - plain).abs().max().item())
    want = dict.fromkeys(pa_counts, 0)
    want["paged_attention_decode"] = L
    check(pa_counts == want, f"paged_attention() launches {pa_counts}")
    check(max(errs_merge) <= 1e-3 and max(errs_plain) <= 1e-3,
          f"kernel 6 on generate's pools: merge {max(errs_merge)}, plain "
          f"{max(errs_plain)}")
    identity = {"what": f"paged_attention() on generate (b)'s prefill "
                f"pools, every layer: {T} tokens, window {win}, f32 q",
                "launches": pa_counts, "max_abs_err_vs_stats_merge":
                max(errs_merge), "max_abs_err_vs_plain": max(errs_plain),
                "tol": 1e-3, "passed": True}
    del cache, kp, vp, bt, outs
    rows["b"], _ = _generate_run(torch, long_model, ids_b, n, "(b)")
    return {"phase": "generate", "model": "Mistral-7B q4_0 (random weights "
            "from seed 0, 32 layers, full width; lm_head dense bf16)",
            "entry": "AutoModelForCausalLM.from_pretrained(LlamaConfig."
            "mistral_7b(), load_in_4bit=True).generate",
            "build_and_quantize_s": build_s, "build_peak_gb": build_peak / 1e9,
            "weights_gb": weight_bytes / 1e9, "runs": rows,
            "pool_identity": identity}, prof


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif hasattr(v, "element_size"):
            yield v


def write_safetensors(torch, fname, tensors):
    """A safetensors file from bf16 tensors: 8-byte little-endian header
    length, the JSON header (padded to 8 bytes), the raw data in order."""
    import struct
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * 2
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(fname, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.contiguous().cpu().view(torch.int16).numpy()
                    .tobytes())


def checkpoint_check(torch, dev):
    """A 2-layer, full-width Mistral-7B checkpoint in bf16 (random
    weights from a seed, ~1.4 GB) written to a temporary directory,
    loaded with ``from_pretrained(dir, load_in_4bit=True)`` on the card
    and on the CPU: prefill logits of a 48-token prompt within 2e-2 of
    their largest magnitude (the card's kernels read activations in
    bf16), and 8 greedy tokens from each (reported)."""
    import tempfile
    from bigdl_tpu_torch.llm.transformers import AutoModelForCausalLM
    H, I, V, L = (CKPT[k] for k in ("hidden_size", "intermediate_size",
                                     "vocab_size", "num_hidden_layers"))
    KV = H // CKPT["num_attention_heads"] * CKPT["num_key_value_heads"]
    g = torch.Generator(device=dev).manual_seed(21)

    def w(n, k, scale=None):
        return (torch.randn((n, k), generator=g, device=dev)
                * (scale or k ** -0.5)).to(torch.bfloat16)

    def norm():
        return (1 + 0.05 * torch.randn((H,), generator=g, device=dev)).to(
            torch.bfloat16)

    tensors = {"model.embed_tokens.weight": w(V, H, 0.02)}
    for l in range(L):
        p = f"model.layers.{l}."
        tensors.update({
            p + "self_attn.q_proj.weight": w(H, H),
            p + "self_attn.k_proj.weight": w(KV, H),
            p + "self_attn.v_proj.weight": w(KV, H),
            p + "self_attn.o_proj.weight": w(H, H),
            p + "mlp.gate_proj.weight": w(I, H),
            p + "mlp.up_proj.weight": w(I, H),
            p + "mlp.down_proj.weight": w(H, I),
            p + "input_layernorm.weight": norm(),
            p + "post_attention_layernorm.weight": norm()})
    tensors["model.norm.weight"] = norm()
    tensors["lm_head.weight"] = w(V, H)
    ids = torch.randint(0, V, (1, 48),
                        generator=torch.Generator().manual_seed(22)).numpy()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        write_safetensors(torch, os.path.join(d, "model.safetensors"),
                          tensors)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(CKPT, f)
        write_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(d, "model.safetensors"))
        del tensors
        out, load_s = {}, {}
        for name, where in (("gpu", dev), ("cpu", "cpu")):
            t0 = time.perf_counter()
            m = AutoModelForCausalLM.from_pretrained(
                d, load_in_4bit=True, max_cache_len=128, device=where)
            load_s[name] = time.perf_counter() - t0
            logits, _ = m(ids)
            out[name] = (logits[0, -1].float().cpu(),
                         m.generate(ids, max_new_tokens=8)[0, 48:].tolist(),
                         m.params)
    g_lg, c_lg = out["gpu"][0], out["cpu"][0]
    check(bool(torch.isfinite(g_lg).all()), "checkpoint logits not finite")
    err = ((g_lg - c_lg).abs().max() / c_lg.abs().max()).item()
    check(err <= 2e-2, f"checkpoint card vs CPU logits: rel err {err}")
    same_planes = all(torch.equal(a.cpu(), b) for a, b in zip(
        _leaves(out["gpu"][2]), _leaves(out["cpu"][2])))
    toks = {k: v[1] for k, v in out.items()}
    lead = next((i for i, (a, b) in enumerate(zip(toks["gpu"], toks["cpu"]))
                 if a != b), len(toks["gpu"]))
    return {"phase": "checkpoint", "model": "Mistral-7B width, 2 layers, "
            "bf16 safetensors (random weights, seed 21)",
            "file_gb": nbytes / 1e9, "write_s": write_s, "load_s": load_s,
            "prompt_tokens": 48, "prefill_max_rel_err_logits": err,
            "tol": 2e-2, "params_bit_identical_card_vs_cpu": same_planes,
            "greedy_tokens": toks, "leading_tokens_equal": lead,
            "passed": True}


# -- phase 8: GLM-4-9B, a group of 16, on both engines ------------------------

# (batch, prompt tokens, new tokens, max_cache_len) of generate, and the
# served requests' prompt lengths and new tokens
GLM_GEN = (2, 1024, 32, 1152)
GLM_SERVE = ((100, 350, 700, 1000), 16)


def glm_phase(torch, dev):
    """GLM-4-9B q4_0 at full width and all 40 layers (32 query heads on 2
    KV heads: paged decode at g = 16, ragged prefill at g = 16 on the
    tensor cores): ``from_pretrained(LlamaConfig.glm4_9b(),
    load_in_4bit=True)`` (random bf16 weights from seed 0 made on the
    card, quantized there; lm_head dense), then ``generate`` on 2 x 1024
    prompts, 32 new tokens, paged decode and then dense decode (the first
    decode step's logits within 2e-2 of each other), each with exact
    launch counts; then ``LLMServer`` (max_batch 4, page 16) on 4 greedy
    requests of 100, 350, 700 and 1000 tokens, 16 new tokens each: exact
    launch counts, in-vocab tokens, one request alone on a fresh server
    equal to its batched tokens, TTFT and decode tok/s. Returns the row
    and a profile of one paged decode step of the ``generate`` batch."""
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.models.llama import (LlamaConfig, forward,
                                                  pageify_cache)
    from bigdl_tpu_torch.llm.serving import LLMServer, paged_decode_step
    from bigdl_tpu_torch.llm.transformers import AutoModelForCausalLM

    cfg = LlamaConfig.glm4_9b()
    L, page = cfg.num_hidden_layers, 16
    B, T, n, cache_len = GLM_GEN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = AutoModelForCausalLM.from_pretrained(
        cfg, load_in_4bit=True, max_cache_len=cache_len, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(model.params))
    hgen = torch.Generator().manual_seed(31)
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=hgen).numpy()

    # the first decode step, paged (kernel 2 at g = 16) against dense
    with torch.no_grad():
        logits, cache = model(ids)
        tok0 = logits[:, -1].argmax(-1).to(torch.int32)
        kp, vp, bt = pageify_cache(cache, page=page)
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        kernels.reset_launch_counts()
        lg_paged = paged_decode_step(model.params, cfg, kp, vp, bt, lens,
                                     tok0, page=page)[0]
        step_stats = kernels.launch_counts()["paged_attention_decode_stats"]
        lg_dense = forward(model.params, cfg, tok0[:, None], cache,
                           torch.full((B, 1), T, dtype=torch.int32,
                                      device=dev))[0][:, 0]
    step_err = ((lg_paged - lg_dense).abs().max()
                / lg_dense.abs().max()).item()
    check(step_stats == L, f"GLM paged step: {step_stats} stats launches")
    check(step_err <= 2e-2, f"GLM first decode step, paged vs dense logits: "
          f"rel err {step_err}")
    prof = profile(torch, lambda: paged_decode_step(
        model.params, cfg, kp, vp, bt, lens, tok0, page=page)[0]
        .argmax(-1).cpu(), f"GLM-4-9B decode step (paged), batch {B}, "
        f"context {T}")
    prof["graph"] = _loop_profile(
        torch, model, kp, vp, bt, T, lg_paged,
        f"GLM-4-9B generate's decode step as one CUDA graph, batch {B}, "
        f"context {T}..")
    del logits, cache, kp, vp, bt, lg_paged, lg_dense
    runs = {}
    runs["paged"], out_p = _generate_run(torch, model, ids, n,
                                         "GLM-4-9B paged")
    model.paged_decode = False
    runs["dense"], out_d = _generate_run(torch, model, ids, n,
                                         "GLM-4-9B dense")
    model.paged_decode = True
    runs["dense"].update(first_step_rel_err=step_err, tol=2e-2,
                         leading_tokens_equal_to_paged=[
                             int(next((i for i in range(n) if out_p[r, T + i]
                                       != out_d[r, T + i]), n))
                             for r in range(B)])
    torch.cuda.empty_cache()

    # LLMServer: 4 requests at once at depth 2 and at depth 1, then one
    # of them alone
    plens, new = GLM_SERVE
    prompts = [torch.randint(0, cfg.vocab_size, (k,), generator=hgen)
               .numpy() for k in plens]
    kw = dict(max_batch=4, max_seq_len=max(plens) + new + page,
              page_size=page)
    serve, outs = _serve_run(torch, model, prompts, new, "GLM depth 2", **kw)
    check(serve["launches"]["ragged_prefill_attention_tc"]
          == len(prompts) * L,
          "GLM prefill attention is not on the tensor-core route")
    serve["depth1"], outs1 = _serve_run(torch, model, prompts, new,
                                        "GLM depth 1", pipeline_depth=1,
                                        **kw)
    check(outs1 == outs, "GLM tokens at depth 1 differ from depth 2")
    alone_i = 1
    srv2 = LLMServer(model, **kw).start()
    try:
        alone = srv2.submit(prompts[alone_i], max_new_tokens=new).get(
            timeout=600)
    finally:
        srv2.stop()
    check(alone == outs[alone_i], f"GLM request {alone_i} alone {alone} != "
          f"batched {outs[alone_i]}")
    serve.update(alone_equals_batched=True, depth1_tokens_equal=True)
    del model, srv2
    return {"phase": "glm", "model": "GLM-4-9B q4_0 (random weights from "
            "seed 0, 40 layers, full width, Hq 32 / Hkv 2; lm_head dense "
            "bf16)", "entry": "AutoModelForCausalLM.from_pretrained("
            "LlamaConfig.glm4_9b(), load_in_4bit=True)",
            "build_and_quantize_s": build_s,
            "build_peak_gb": build_peak / 1e9,
            "weights_gb": weight_bytes / 1e9, "generate": runs,
            "serve": serve}, prof


# -- phase 5: the BERT-base low-bit path --------------------------------------

# which kernel each pipeline's linears launch; 6 linears in each of the 12
# layers, plus the pooler and the classifier
BERT_PIPELINE_KERNELS = {"float (trace)": None, "int8": "int8_matmul",
                         "asym_int4": "asym_int4_matmul",
                         "sym_int4": "int4_matmul",
                         "quantize_model": "int8_matmul"}
MATMUL_KERNELS = ("int4_matmul", "asym_int4_matmul", "int8_matmul")


def bert_path(torch, dev):
    """BERT-base (full width, 12 layers, weights from a seed) through
    nano's pipelines: ``trace`` (float, the yardstick),
    ``InferenceOptimizer.quantize`` with int8 / asym_int4 / sym_int4, and
    the DLlib ``nn.quantized.quantize_model`` surgery. Each pipeline
    serves batch 8 x 128: exact launch counts (zeroed just before), ms
    per forward (median of 10, host clock to the numpy result),
    sequences/s, peak memory; then the card's log-probs against the same
    quantized model's plain path on the CPU at batch 2 x 128 — within
    2e-2 of their largest magnitude (the kernels read x in bf16, the CPU
    path in f32) and the same argmax on every row."""
    import copy

    import numpy as np
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.models.bert import BertConfig, build_classifier
    from bigdl_tpu_torch.nano import InferenceOptimizer
    from bigdl_tpu_torch.nano.inference_optimizer import _CompiledModel
    from bigdl_tpu_torch.nn import set_seed

    cfg = BertConfig.base()
    set_seed(0)
    t0 = time.perf_counter()
    model = build_classifier(cfg, 2, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.randint(0, cfg.vocab_size, (8, 128),
                        generator=torch.Generator().manual_seed(5)).numpy()
    n_linears = 6 * cfg.num_hidden_layers + 2
    builders = {
        "float (trace)": lambda: InferenceOptimizer.trace(model, device=dev),
        "int8": lambda: InferenceOptimizer.quantize(model, "int8",
                                                    device=dev),
        "asym_int4": lambda: InferenceOptimizer.quantize(
            model, "asym_int4", device=dev),
        "sym_int4": lambda: InferenceOptimizer.quantize(
            model, "sym_int4", device=dev),
        "quantize_model": lambda: InferenceOptimizer._quantize_convs(
            model, device=dev)}
    rows = {}
    for name, build in builders.items():
        t0 = time.perf_counter()
        pipe = build()
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        pipe.forward(ids)                    # warm-up: cuBLAS handles
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        y = pipe.forward(ids)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check(y.shape == (8, 2) and bool(np.isfinite(y).all()),
              f"BERT {name}: output {y.shape} not finite")
        want = dict.fromkeys(counts, 0)
        kern = BERT_PIPELINE_KERNELS[name]
        if kern:
            want[kern] = n_linears
            # the M = 1024 linears on the tensor cores, the pooler and
            # the classifier (M = 8) on the GEMV
            want[f"{kern}_tc"] = sum(
                c for _, m, _, n, c in BERT_SHAPES
                if kernels.matmul_route(m, n) == "tc")
            want[f"{kern}_gemv"] = n_linears - want[f"{kern}_tc"]
        check(counts == want, f"BERT {name}: launch counts {counts} != "
              f"{want}")
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            pipe.forward(ids)
            walls.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(walls)
        cpu = _CompiledModel(copy.deepcopy(pipe._model), "cpu").forward(
            ids[:2])
        card = pipe.forward(ids[:2])
        err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
        same = bool((card.argmax(1) == cpu.argmax(1)).all())
        check(err <= 2e-2 and same, f"BERT {name}: card vs CPU log-probs "
              f"{card.tolist()} vs {cpu.tolist()} (rel err {err})")
        rows[name] = {"kernel": BERT_PIPELINE_KERNELS[name],
                      "launches": counts, "convert_s": convert_s,
                      "ms_per_forward": ms, "ms_all": walls,
                      "sequences_per_s": 8 / ms * 1e3,
                      "peak_mem_gb": peak / 1e9,
                      "card_vs_cpu_rel_err": err, "same_argmax": same,
                      "logprobs_row0": y[0].tolist()}
        if name == "int8":
            prof = profile(torch, lambda: pipe.forward(ids),
                           "BERT-base int8 forward, batch 8 x 128")
        del pipe
    return {"phase": "bert", "model": "BERT-base classifier (random "
            "weights from seed 0, 12 layers, full width), 2 labels",
            "batch": [8, 128], "weights_build_s": build_s,
            "linears_per_forward": n_linears, "tol": 2e-2,
            "pipelines": rows}, prof


# -- phase 9: Mixtral-8x7B, the mixture-of-experts FFN ------------------------

# Mixtral-8x7B at full width, depth cut 32 -> 16 layers (~47 GB of bf16
# weights: the whole model's 93 GB does not fit the card, and the JAX
# package does not quantize expert weights)
MIXTRAL_LAYERS = 16
MIXTRAL_FACTORS = (1.25, 0.0)
MIX_GEN = (4, 512, 32, 1024)       # generate: batch, prompt, new, cache


def _mixtral_model(model, factor):
    """``model`` at another expert capacity factor, sharing its weights."""
    import dataclasses
    from bigdl_tpu_torch.llm.models.llama import LlamaForCausalLM
    return LlamaForCausalLM(
        dataclasses.replace(model.config, expert_capacity_factor=factor),
        model.params, max_cache_len=model.max_cache_len, device=model.device)


def _drive(srv, reqs, late=(), late_after=4):
    """Serve inline (``_admit`` then ``_step``, the engine loop's pass):
    ``reqs`` are ``(prompt, new, class)`` submitted at once, ``late``
    after ``late_after`` passes. Returns the request handles."""
    out, n = [srv.submit(p, k, c) for p, k, c in reqs], 0
    while len(out) < len(reqs) + len(late) or not all(
            r.done.is_set() for r in out):
        if n == late_after:
            out += [srv.submit(p, k, c) for p, k, c in late]
        srv._admit()
        srv._step()
        n += 1
    while srv._inflight:
        srv._drain_next()
    return out


def _engine_mode_runs(torch, model, label):
    """(c) one short run each of ``kvcache=True`` + ``mixed=True``,
    ``spec=True`` and ``priority=True`` (with the prefix cache), driven
    inline: every request completes with in-vocab tokens of its count,
    the decode graph and the mode's own graphs are captured and
    replayed, and the mode did its work (mixed passes and cache hits,
    verify passes, a preemption and its resume)."""
    import numpy as np
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.serving import LLMServer
    cfg = model.config
    gen = torch.Generator().manual_seed(21)

    def rand(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()

    shared = rand(128)
    pattern = rand(24)
    runs = {
        "kvcache+mixed": (dict(kvcache=True, mixed=True, chunk_tokens=256,
                               max_batch=8, max_seq_len=2048),
                          [(np.concatenate([shared, rand(17 + 30 * j)]),
                            32, None) for j in range(4)],
                          [(rand(1024), 16, None)]),
        "spec": (dict(spec=True, spec_k=8, **SERVE_7B),
                 [(np.tile(pattern, 12), 64, None)], []),
        "priority": (dict(priority=True, kvcache=True, max_batch=2,
                          max_seq_len=512),
                     [(rand(100 + 20 * j), 48, "batch") for j in range(2)],
                     [(rand(60), 16, "interactive")]),
    }
    out = {}
    for name, (kw, reqs, late) in runs.items():
        srv = LLMServer(model, **kw)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        hs = _drive(srv, reqs, late)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        graphs = {"decode": srv._decode} | {
            f"mixed {b}": st for b, (st, _, _) in srv._mixed_steps.items()
        } | {f"verify {b}": st for b, (st, _, _) in srv._spec_steps.items()}
        replays = {k: g.replays for k, g in graphs.items()}
        row = {"what": f"{label} {name}", "options": {
            k: v for k, v in kw.items() if k != "max_seq_len"},
            "requests": len(hs), "passes": srv.steps, "wall_s": wall,
            "graph_replays": replays, "launches": counts,
            "mixed_passes": srv.mixed_passes,
            "prefill_chunks": srv.prefill_chunks_total,
            "prefix_tokens_saved": srv.prefix_tokens_saved,
            "spec_passes": srv.spec_passes,
            "drafts_accepted": srv.spec_accepted_total,
            "drafts_proposed": srv.spec_proposed_total,
            "preemptions": srv.preemptions_total,
            "resumes": srv.preempt_resumes_total}
        srv.stop()
        check(not srv.errors, f"{label} {name}: engine errors {srv.errors}")
        for h, (_, k, _) in zip(hs, reqs + late):
            check(len(h.tokens) == k and all(0 <= t < cfg.vocab_size
                                             for t in h.tokens),
                  f"{label} {name}: tokens {h.tokens}")
        check(replays["decode"] > 0, f"{label} {name}: decode not replayed")
        check(counts["paged_attention_decode_stats"] > 0
              and counts["ragged_prefill_attention_tc"] > 0,
              f"{label} {name}: kernels 2 / 3 did not run: {counts}")
        mode = [v for k, v in replays.items() if k.startswith(
            {"kvcache+mixed": "mixed", "spec": "verify"}.get(name, "-"))]
        if name == "kvcache+mixed":
            check(row["mixed_passes"] > 0 and row["prefix_tokens_saved"] > 0
                  and any(mode), f"{label} {name}: {row}")
        elif name == "spec":
            check(row["spec_passes"] > 0 and any(mode),
                  f"{label} {name}: {row}")
        else:
            check(row["preemptions"] >= 1
                  and row["resumes"] == row["preemptions"],
                  f"{label} {name}: {row}")
        out[name] = row
        del srv
        torch.cuda.empty_cache()
    return out


def _moe_step_checks(torch, model):
    """A Mixtral batch-8 decode step (lengths 33..316 over random bf16
    pools) at each capacity factor: the engine's step as one captured
    CUDA graph against the eager step, bit for bit over 4 steps (ids,
    logits, lengths, every real page); one layer's ``_moe_ffn`` and its
    three expert products timed at the rows the factor gives them (the
    step's 8 at no-drop, C = 3 places at 1.25) against their byte
    bound (every expert's weights read once); no copy of an expert
    weight in the eager step (``torch.profiler`` with shapes); and at
    the preset factor the graphed step profiled as in phase 4."""
    from torch.profiler import ProfilerActivity, profile as trace
    from bigdl_tpu_torch.llm.graphs import CapturedStep
    from bigdl_tpu_torch.llm.models.llama import _moe_ffn, layer_params
    from bigdl_tpu_torch.llm.serving import (bind_decode_step,
                                             paged_decode_step_sampled)
    cfg0, dev = model.config, model.device
    B, page, cap = 8, 16, 32
    E, I, H = cfg0.num_experts, cfg0.intermediate_size, cfg0.hidden_size
    L, P = cfg0.num_hidden_layers, 1 + B * cap
    gen = torch.Generator(device=dev).manual_seed(17)
    shape = (L, P, cfg0.num_key_value_heads, page, cfg0.head_dim)
    base = {"kp": torch.randn(shape, generator=gen, device=dev).bfloat16(),
            "vp": torch.randn(shape, generator=gen, device=dev).bfloat16(),
            "bt": (1 + torch.arange(B * cap, device=dev)).reshape(
                B, cap).to(torch.int32),
            "lens": torch.tensor([33, 73, 114, 155, 196, 236, 276, 316],
                                 dtype=torch.int32, device=dev),
            "last": torch.randn((B, cfg0.vocab_size), generator=gen,
                                device=dev),
            "active": torch.ones(B, dtype=torch.bool, device=dev),
            "toks": torch.zeros(B, dtype=torch.int32, device=dev)}
    expert_bytes = 3 * E * I * H * 2
    lp = layer_params(model.params["layers"], 0)
    h = torch.randn((B, 1, H), generator=gen, device=dev).bfloat16()
    out = {}
    for factor in MIXTRAL_FACTORS:
        m = _mixtral_model(model, factor)
        cfg = m.config
        g = {k: v.clone() for k, v in base.items()}
        e = {k: v.clone() for k, v in base.items()}
        captured = CapturedStep(bind_decode_step(
            m.params, cfg, *(g[k] for k in (
                "kp", "vp", "bt", "lens", "last", "active", "toks")),
            page=page), dev)
        with torch.inference_mode():
            for i in range(4):
                captured()
                t, lg, _, _, ln = paged_decode_step_sampled(
                    m.params, cfg, e["kp"], e["vp"], e["bt"], e["lens"],
                    e["last"], e["active"], page=page)
                e["last"], e["lens"] = lg, ln
                check(torch.equal(t, g["toks"]) and torch.equal(
                    lg, g["last"]) and torch.equal(ln, g["lens"]),
                    f"graphed Mixtral step {i} (factor {factor}) differs "
                    "from the eager step")
            check(torch.equal(e["kp"][:, 1:], g["kp"][:, 1:])
                  and torch.equal(e["vp"][:, 1:], g["vp"][:, 1:]),
                  f"graphed Mixtral steps (factor {factor}) wrote other "
                  "pages than the eager steps")
            # one eager step traced with shapes: no copy of an expert
            # weight (a copy would move 2.82 GB a layer, every step)
            with trace(activities=[ProfilerActivity.CPU],
                       record_shapes=True) as prof:
                paged_decode_step_sampled(
                    m.params, cfg, e["kp"], e["vp"], e["bt"], e["lens"],
                    e["last"], e["active"], page=page)
                torch.cuda.synchronize()
        wshapes = ([E, I, H], [E, H, I], [I, H], [H, I])
        copies = [(ev.name, ev.input_shapes) for ev in prof.events()
                  if ev.name in ("aten::copy_", "aten::clone",
                                 "aten::contiguous", "aten::_to_copy")
                  and any(list(sh) in wshapes for sh in ev.input_shapes)]
        check(not copies, f"Mixtral step copies an expert weight: {copies}")
        bmms = sum(ev.name in ("aten::bmm", "aten::matmul")
                   for ev in prof.events())
        # the rows an expert's products take, as _moe_ffn sizes them:
        # every row (no-drop), else C = ceil(S k / E * factor) places
        rows = B if factor <= 0 else max(math.ceil(
            B * cfg.num_experts_per_tok / E * factor), 1)
        with torch.inference_mode():
            moe_ms = time_ms(lambda: _moe_ffn(lp, h, cfg))
            xin = torch.randn((E, rows, H), generator=gen,
                              device=dev).bfloat16()
            wg, wu, wd = (lp[n]["w"] for n in ("gate_proj", "up_proj",
                                               "down_proj"))
            a = torch.randn((E, rows, I), generator=gen,
                            device=dev).bfloat16()
            prod_ms = time_ms(lambda: (
                torch.matmul(xin, wg.transpose(1, 2)),
                torch.matmul(xin, wu.transpose(1, 2)),
                torch.matmul(a, wd.transpose(1, 2))))
        row = {"factor": factor, "graph_bit_equal_to_eager_steps": 4,
               "expert_weight_copies": 0, "matmul_ops_per_step": bmms,
               "moe_ffn_ms_per_layer": moe_ms,
               "expert_products_ms_per_layer": prod_ms,
               "expert_product_rows": rows,
               "expert_bytes_per_layer": expert_bytes,
               "expert_bound_ms_per_layer": bound(expert_bytes, 0)[0],
               "moe_ffn_ms_per_step": moe_ms * L,
               "capture_launches": dict(captured.launches)}
        if factor == MIXTRAL_FACTORS[0]:
            row["graph"] = profile_graphed(
                torch, captured, lambda: g["toks"].cpu(),
                f"Mixtral decode step as one CUDA graph, batch {B}, "
                f"{L} layers, factor {factor}")
        captured.close()
        out[str(factor)] = row
        del g, e, captured
        torch.cuda.empty_cache()
    return out


def mixtral_phase(torch, dev):
    """Phase 9: Mixtral-8x7B (``LlamaConfig.mixtral_8x7b()``, 16 of 32
    layers, every width as published: hidden 4096, 32 / 8 heads, D 128,
    FFN 14336, 8 experts top-2, vocab 32000) in bf16, weights drawn on
    the card one expert at a time from a seed by
    ``AutoModelForCausalLM.from_pretrained``. The card-vs-CPU check on a
    2-layer cut at both capacity factors; (a) ``generate`` 4 x 512, 32
    new, paged then dense; (b) ``LLMServer`` on phase 3's 8 prompts at
    capacity 1.25 and 0.0, depths 2 and 1 (exact launch counts: no
    linear of ours, one kernel 3 a layer a prefill, one kernel 2 a layer
    a step); (c) the prefix cache with mixed dispatch, speculation and
    priority at 1.25; the graphed step held to the eager one and
    profiled."""
    import dataclasses
    from bigdl_tpu_torch.llm.models.llama import LlamaConfig
    from bigdl_tpu_torch.llm.transformers import AutoModelForCausalLM

    refs = {str(f): reference_check(torch, dev, "mixtral_8x7b", f)
            for f in MIXTRAL_FACTORS}
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(LlamaConfig.mixtral_8x7b(),
                              num_hidden_layers=MIXTRAL_LAYERS)
    B, T, n, cache_len = MIX_GEN
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = AutoModelForCausalLM.from_pretrained(
        cfg, max_cache_len=cache_len, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(model.params))

    ids = torch.randint(0, cfg.vocab_size, (B, T),
                        generator=torch.Generator().manual_seed(19)).numpy()
    gen_rows = {}
    gen_rows["paged"], out_p = _generate_run(torch, model, ids, n, "paged")
    model.paged_decode = False
    gen_rows["dense"], out_d = _generate_run(torch, model, ids, n, "dense")
    model.paged_decode = True
    gen_rows["dense"]["leading_tokens_equal_to_paged"] = [
        _lead(out_p[r, T:].tolist(), out_d[r, T:].tolist())
        for r in range(B)]
    torch.cuda.empty_cache()

    prompts = _phase3_prompts(torch, cfg)
    serve = {}
    for f in MIXTRAL_FACTORS:
        m = _mixtral_model(model, f)
        r2, o2 = _serve_run(torch, m, prompts, 32,
                            f"Mixtral factor {f} depth 2", **SERVE_7B)
        r1, o1 = _serve_run(torch, m, prompts, 32,
                            f"Mixtral factor {f} depth 1",
                            pipeline_depth=1, **SERVE_7B)
        if f <= 0:
            # no-drop: a row's experts do not depend on the other rows
            check(o1 == o2, "Mixtral no-drop tokens differ by depth")
        r2["depth1"] = r1
        r2["depth1_leading_equal_tokens"] = [_lead(a, b)
                                             for a, b in zip(o1, o2)]
        serve[str(f)] = r2
        torch.cuda.empty_cache()
    engine = _engine_mode_runs(torch, model, "Mixtral")
    steps = _moe_step_checks(torch, model)
    busy = steps[str(MIXTRAL_FACTORS[0])]["graph"]["device_busy_ms"]
    for f, r in serve.items():
        for d in (r, r["depth1"]):
            d["idle_share_vs_profiled_busy"] = (
                1 - busy / d["decode_step_ms"] if busy else None)
    del model
    torch.cuda.empty_cache()
    return {"phase": "mixtral", "model": "Mixtral-8x7B (bf16, random "
            f"weights from seed 0, {MIXTRAL_LAYERS} of 32 layers, full "
            "width)", "entry": "AutoModelForCausalLM.from_pretrained("
            "LlamaConfig.mixtral_8x7b() cut to 16 layers)",
            "weights_gb": weight_bytes / 1e9, "build_s": build_s,
            "reference": refs, "generate": gen_rows, "serve": serve,
            "engine_modes": engine, "step": steps}


# -- phase 10: the GPT-NeoX, StarCoder and Bloom families -----------------------

# the three families at full width and depth, q4_0 drawn on the card; the
# StarCoder and Bloom generate runs (batch, prompt tokens, new tokens,
# max_cache_len)
FAMILIES = ("StarCoder-15B", "GPT-NeoX-20B", "Bloom-7b1")
FAMILY_GEN = {"StarCoder-15B": (1, 512, 32, 1024),
              "Bloom-7b1": (4, 512, 32, 1024)}


def _family_model(torch, dev, name):
    """``name`` at full width and depth: random bf16 weights from seed 0
    drawn on the card one layer at a time, each decoder linear quantized
    to q4_0 as it is drawn (``from_config(load_in_low_bit=
    "sym_int4")``; the heads stay bf16). Returns the model, the build
    seconds and the weights' GB."""
    cfg, cls = _family(name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = cls.from_config(cfg, seed=0, load_in_low_bit="sym_int4",
                            max_cache_len=1024, device=dev)
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in _leaves(model.params))
    return model, time.perf_counter() - t0, gb / 1e9


def _family_served(torch, model, name):
    """Phase 3's 8 prompts served at depth 2 (:func:`_serve_run`: exact
    launch counts a run) and the served graph's launches a step: the 6
    q4_0 linears a layer on the GEMV and one kernel 2 a layer (the bf16
    heads are ``torch.matmul``); then the step held bit for bit against
    the eager step and profiled (:func:`profile_decode`)."""
    L = model.config.num_hidden_layers
    row, _ = _serve_run(torch, model, _phase3_prompts(torch, model.config),
                        32, f"{name} depth 2", **SERVE_7B)
    want = {"int4_matmul": 6 * L, "int4_matmul_gemv": 6 * L,
            "paged_attention_decode_stats": L}
    check(row["step_launches"] == want,
          f"{name}: a step launches {row['step_launches']} != {want}")
    prof = profile_decode(torch, model, name)
    busy = prof["graph"]["device_busy_ms"]
    row["idle_share_vs_profiled_busy"] = (
        1 - busy / row["decode_step_ms"] if busy else None)
    torch.cuda.empty_cache()
    return row, prof


def family_phase(torch, dev):
    """Phase 10: the GPT-NeoX, StarCoder and Bloom families at full width,
    q4_0 weights drawn on the card from a seed (:func:`_family_model`).
    (a) each family cut to 2 layers on the card against the CPU's plain
    path (:func:`reference_check`); (b) StarCoder-15B, all 40 layers:
    ``generate`` 1 x 512 + 32 (paged loop, exact launch counts), phase
    3's 8 prompts served at depth 2 (TTFT, tok/s, ms a step, peak
    memory, exact launches a run and a step), the graphed step bit-equal
    to the eager one, and short runs with the prefix cache + mixed
    dispatch, speculation and priority, each capturing its graphs; (c)
    GPT-NeoX-20B, all 44 layers: the same served run and the prefix-cache
    run of phase 3b (a); (d) Bloom-7b1, all 30 layers: ``generate``
    4 x 512 + 32 (dense: kernel 1 only), and ``LLMServer`` refusing it."""
    from bigdl_tpu_torch.llm.serving import LLMServer
    out = {"reference": {n: reference_check(torch, dev, n)
                         for n in FAMILIES}}
    torch.cuda.empty_cache()
    for name in FAMILIES:
        torch.cuda.reset_peak_memory_stats()
        model, build_s, gb = _family_model(torch, dev, name)
        cfg = model.config
        row = out[name] = {
            "model": f"{name} q4_0 (random weights from seed 0, "
            f"{cfg.num_hidden_layers} layers, full width; bf16 heads)",
            "entry": f"{type(model).__name__}.from_config(..., "
            "load_in_low_bit='sym_int4')", "weights_gb": gb,
            "build_s": build_s}
        if name in FAMILY_GEN:
            B, T, n, _ = FAMILY_GEN[name]
            ids = torch.randint(0, cfg.vocab_size, (B, T),
                                generator=torch.Generator().manual_seed(23)
                                ).numpy()
            row["generate"], _ = _generate_run(
                torch, model, ids, n,
                f"{name} {'paged' if model.paged_decode else 'dense'}")
        if name == "Bloom-7b1":
            try:
                LLMServer(model)
            except NotImplementedError as e:
                row["engine_refuses"] = str(e)
            check("paged decode" in row.get("engine_refuses", ""),
                  "LLMServer did not refuse Bloom")
        else:
            row["serve"], row["step"] = _family_served(torch, model, name)
        if name == "StarCoder-15B":
            row["engine_modes"] = _engine_mode_runs(torch, model, name)
        if name == "GPT-NeoX-20B":
            row["prefix_cache"] = serve_prefix_cache(
                torch, model, name, row["model"])
        del model
        torch.cuda.empty_cache()
    out["phase"] = "families"
    return out


# -- phase 11: the HTTP worker and the OpenAI gateway over the engine ---------

HTTP_WATCHDOG_S = 5.0          # the served engine's watchdog_timeout
HTTP_CHAT = ("Name two prime numbers.", "Say hi.")
HTTP_CHAT_NEW = 16


def _http(addr, method, path, body=None, timeout=600):
    """One HTTP call to the worker: ``(status, parsed body, headers)``
    (header names lower-cased)."""
    import http.client
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {} if body is None else
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read().decode()
        try:
            data = json.loads(data)
        except ValueError:
            pass
        return r.status, data, {k.lower(): v for k, v in r.getheaders()}
    finally:
        conn.close()


def _http_lines(addr, path, body, sse=False, timeout=600):
    """A streamed POST: ``(seconds from the send to the first chunk that
    carries a token, the chunks)``; SSE events when ``sse``, else the
    native stream's JSON lines."""
    import http.client

    from bigdl_tpu_torch.llm.api import parse_sse
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        check(r.status == 200, f"{path}: status {r.status}")
        lines = (parse_sse(r) if sse else
                 (json.loads(x) for x in r if x.strip()))
        first, chunks = None, []
        for obj in lines:
            chunks.append(obj)
            has = (obj.get("output_ids") if not sse else
                   any(c.get("token_ids") for c in obj["choices"]))
            if first is None and has:
                first = time.perf_counter() - t0
        return first, chunks
    finally:
        conn.close()


def _ascii(text):
    """The ASCII characters of a text: what a byte-level decode gives
    whatever the grouping of the bytes into drained deltas (the gateway
    decodes each delta alone, so a multi-byte character split across two
    deltas becomes replacement characters)."""
    return "".join(c for c in text if ord(c) < 128)


def _sse_ids(chunks):
    """The token ids of choice 0 joined over an SSE stream."""
    return [t for c in chunks for ch in c["choices"] if ch["index"] == 0
            for t in ch.get("token_ids", [])]


def _metrics(addr):
    from bigdl_tpu_torch import observability as obs
    st, text, _ = _http(addr, "GET", "/metrics")
    check(st == 200, f"/metrics: status {st}")
    return obs.parse_prometheus(text)


def _delta(m1, m0, name, labels=()):
    return m1.get(name, {}).get(labels, 0.0) - m0.get(name, {}).get(
        labels, 0.0)


def _wait(cond, timeout, what, every=0.005):
    t0 = time.monotonic()
    while not cond():
        check(time.monotonic() - t0 < timeout, f"{what}: timed out")
        time.sleep(every)
    return time.monotonic()


def _warm_inline(torch, srv, prompts, what):
    """Every prompt's prefill bucket and the decode graph's capture,
    driven inline before ``start()`` arms the watchdog (a first use looks
    like a stall to it)."""
    with torch.inference_mode():
        reqs = [srv.submit(p, 2) for p in prompts]
        while not all(r.done.is_set() for r in reqs):
            srv._admit()
            srv._step()
        while srv._inflight:
            srv._drain_next()
    check(srv._decode.graph is not None and not srv.errors,
          f"{what} warm-up: {srv.errors}")


def _pass_profile(torch, model, on):
    """One window of engine passes traced with ``torch.profiler``, with
    observability (and the flight recorder) ``on`` or off: 8 rows of 129
    prompt tokens decoding, driven inline after the decode graph is
    captured; no page grant falls in the window (positions 132..138, the
    first a profiler warm-up left out of the counts), so a pass is one
    graph replay, the token copy and the drain. Host launch calls,
    kernels and device busy ms a pass."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile as trace, schedule

    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.observability import flight

    (obs.enable if on else obs.disable)()
    flight.enabled = on
    cfg, n = model.config, 6
    gen = torch.Generator().manual_seed(21)
    srv = LLMServer(model, **SERVE_7B)
    try:
        with torch.inference_mode():
            reqs = [srv.submit(torch.randint(0, cfg.vocab_size, (129,),
                                             generator=gen).numpy(), 14)
                    for _ in range(8)]
            for _ in range(4):
                srv._admit()
                srv._step()
            check(srv._decode.graph is not None
                  and all(r in srv._slots for r in reqs),
                  "phase 11 profile: rows not decoding on the graph")
            # the counted window holds exactly its own passes' device
            # work: a warm-up pass first (the tracer can miss the events
            # just after it starts), no work in flight when the window
            # opens (a pipelined step enqueued before it would land
            # inside by time), all of it done when it closes
            with trace(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=n,
                                         repeat=1)) as prof:
                for i in range(n + 1):
                    srv._admit()
                    srv._step()
                    if i in (0, n):
                        torch.cuda.synchronize()
                    prof.step()
            while not all(r.done.is_set() for r in reqs):
                srv._admit()
                srv._step()
        check(not srv.errors, f"phase 11 profile: {srv.errors}")
    finally:
        srv.stop()
        obs.enable()
        flight.enabled = False
    cuda_t = torch.autograd.DeviceType.CUDA
    # the schedule's step markers ride the device timeline too
    kern = [e for e in prof.events() if e.device_type == cuda_t
            and not e.name.startswith("ProfilerStep")]
    host = Counter(e.name for e in prof.events()
                   if e.device_type != cuda_t and e.name in HOST_LAUNCH_CALLS)
    return {"observability": on,
            "host_launch_calls_per_pass": sum(host.values()) / n,
            "host_launch_calls_by_name": {k: v / n for k, v in host.items()},
            "kernels_per_pass": len(kern) / n,
            "device_busy_ms_per_pass": sum(
                e.time_range.elapsed_us() for e in kern) / 1e3 / n}


def serve_http(torch, model, serve):
    """Phase 11: phase 3's engine served over HTTP by the port's
    ``LLMWorker`` with the OpenAI gateway, on phase 3's model."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch import reliability
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.api import ByteTokenizer, apply_chat_template
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.llm.worker import LLMWorker
    from bigdl_tpu_torch.observability import flight

    cfg, new = model.config, 32
    prompts = [p.tolist() for p in _phase3_prompts(torch, cfg)]
    want = serve["outputs"]
    tok = ByteTokenizer()
    out = {"phase": "serve_http", "model": "Llama-2-7B q4_0 (phase 3's "
           "model)", "engine": dict(SERVE_7B, slo=True,
                                    watchdog_timeout=HTTP_WATCHDOG_S,
                                    max_queue=16)}
    obs.enable()
    srv = LLMServer(model, slo=True, watchdog_timeout=HTTP_WATCHDOG_S,
                    max_queue=16, **SERVE_7B)
    _warm_inline(torch, srv, prompts, "phase 11")
    srv.start()
    worker = LLMWorker(srv, api=True, tokenizer=tok).start()
    addr = worker.address
    try:
        m0 = _metrics(addr)
        kernels.reset_launch_counts()
        # (a) 8 concurrent blocking requests
        body = [{"prompt_ids": p, "max_new_tokens": new} for p in prompts]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            res = list(ex.map(lambda b: _http(addr, "POST",
                                              "/worker_generate", b), body))
        a_wall = time.perf_counter() - t0
        for i, (st, b, _) in enumerate(res):
            check(st == 200 and b["output_ids"] == want[i]
                  and b["finish_reason"] == "length",
                  f"(a) request {i}: {st} {b}")
        # (b) the same, streamed
        mb0 = _metrics(addr)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            sres = list(ex.map(lambda b: _http_lines(
                addr, "/worker_generate_stream", b), body))
        b_wall = time.perf_counter() - t0
        mb1 = _metrics(addr)
        for i, (first, chunks) in enumerate(sres):
            last = chunks[-1]
            check(last["done"] and last["output_ids"] == want[i]
                  and "error" not in last, f"(b) stream {i}: {last}")
        name = "bigdl_llm_ttft_seconds"
        ttft_n = _delta(mb1, mb0, name + "_count")
        check(ttft_n == 8, f"(b) TTFT sketch count {ttft_n}")
        first_ms = [f * 1e3 for f, _ in sres]
        out["stream"] = {
            "first_chunk_ms": first_ms,
            "first_chunk_ms_mean": statistics.mean(first_ms),
            "engine_ttft_ms_mean": _delta(mb1, mb0, name + "_sum")
            / ttft_n * 1e3,
            "engine_ttft_ms_p50_p90_p99_cumulative": [
                mb1[name][(("quantile", q),)] * 1e3
                for q in ("0.5", "0.9", "0.99")],
            "aggregate_tok_per_s": 8 * new / b_wall, "wall_s": b_wall,
            "phase3_decode_tok_per_s": serve["decode_tok_per_s"],
            "phase3_ttft_ms_mean": serve["ttft_ms_mean"]}
        out["blocking"] = {"wall_s": a_wall,
                           "aggregate_tok_per_s": 8 * new / a_wall}
        # (c) the gateway, plain and SSE
        gw, served, n_req = {}, 16 * new, 16
        for i in (0, 1):
            req = {"model": "bigdl-tpu-llm", "prompt": prompts[i],
                   "max_tokens": new}
            st, b, _ = _http(addr, "POST", "/v1/completions", req)
            ch = b["choices"][0] if st == 200 else {}
            usage = {"prompt_tokens": len(prompts[i]),
                     "completion_tokens": new,
                     "total_tokens": len(prompts[i]) + new}
            check(st == 200 and ch["token_ids"] == want[i]
                  and _ascii(ch["text"]) == _ascii(tok.decode(want[i]))
                  and b["usage"] == usage, f"(c) completion {i}: {st} {b}")
            gw[f"completion {i}"] = {
                "text_equals_decode": ch["text"] == tok.decode(want[i])}
            _, chunks = _http_lines(addr, "/v1/completions",
                                    dict(req, stream=True), sse=True)
            check(_sse_ids(chunks) == want[i]
                  and chunks[-1]["usage"] == usage,
                  f"(c) completion {i} SSE: {chunks[-1]}")
        for k, text in enumerate(HTTP_CHAT):
            messages = [{"role": "user", "content": text}]
            ids = tok.encode(apply_chat_template("plain", messages))
            st, ref, _ = _http(addr, "POST", "/worker_generate",
                               {"prompt_ids": ids,
                                "max_new_tokens": HTTP_CHAT_NEW})
            check(st == 200, f"(c) chat reference {k}: {st} {ref}")
            ref = ref["output_ids"]
            req = {"messages": messages, "max_tokens": HTTP_CHAT_NEW}
            st, b, _ = _http(addr, "POST", "/v1/chat/completions", req)
            usage = {"prompt_tokens": len(ids),
                     "completion_tokens": HTTP_CHAT_NEW,
                     "total_tokens": len(ids) + HTTP_CHAT_NEW}
            text = b["choices"][0]["message"]["content"] if st == 200 \
                else ""
            check(st == 200 and _ascii(text) == _ascii(tok.decode(ref))
                  and b["usage"] == usage, f"(c) chat {k}: {st} {b}")
            _, chunks = _http_lines(addr, "/v1/chat/completions",
                                    dict(req, stream=True), sse=True)
            check(_sse_ids(chunks) == ref and chunks[-1]["usage"] == usage,
                  f"(c) chat {k} SSE: {chunks[-1]}")
            gw[f"chat {k}"] = {"prompt_tokens": len(ids), "ids": ref,
                               "text_equals_decode":
                                   text == tok.decode(ref)}
        served += 4 * new + 6 * HTTP_CHAT_NEW
        n_req += 4 + 6
        out["launches"] = kernels.launch_counts()
        # (d) the engine's own counts of what it served
        m1 = _metrics(addr)
        d = {"decode_tokens": _delta(m1, m0, "bigdl_llm_decode_tokens_total"),
             "requests_done": _delta(m1, m0, "bigdl_llm_requests_total",
                                     (("reason", "done"),)),
             "ttft_count": _delta(m1, m0, "bigdl_llm_ttft_seconds_count")}
        check(d == {"decode_tokens": served, "requests_done": n_req,
                    "ttft_count": n_req}, f"(d) metric deltas {d} against "
              f"{served} tokens, {n_req} requests")
        check("bigdl_slo_requests_total" in m1, "(d) no SLO series")
        out["metrics"] = dict(d, tokens_served=served, requests=n_req,
                              slo_requests={
                                  ",".join(f"{k}={v}" for k, v in lab): n
                                  for lab, n in m1[
                                      "bigdl_slo_requests_total"].items()})
        out["gateway"] = gw
        # (f) the watchdog: a stall of twice the timeout mid-decode
        plan = reliability.FaultPlan(seed=0).add(
            "worker.stall", "delay", after=8, times=1,
            delay=2 * HTTP_WATCHDOG_S)
        reliability.set_plan(plan)
        with ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(_http_lines, addr, "/worker_generate_stream",
                              {"prompt_ids": prompts[i],
                               "max_new_tokens": 96}) for i in (2, 3)]
            t_stall = _wait(lambda: plan.fired, 120, "(f) the stall")
            t_503 = _wait(lambda: _http(addr, "GET", "/healthz")[:2][0]
                          == 503, HTTP_WATCHDOG_S + 5, "(f) 503",
                          every=0.05)
            st, hz, _ = _http(addr, "GET", "/healthz")
            streams = [f.result()[1] for f in futs]
        t_ok = _wait(lambda: _http(addr, "GET", "/healthz")[0] == 200,
                     4 * HTTP_WATCHDOG_S, "(f) recovery", every=0.05)
        reliability.set_plan(None)
        check(t_503 - t_stall <= HTTP_WATCHDOG_S + 1.0 and st == 503
              and hz["status"] == "stalled",
              f"(f) /healthz {st} {hz} {t_503 - t_stall:.2f}s after the "
              "stall")
        for s in streams:
            check(s[-1]["done"] and s[-1].get("retriable") is True
                  and "error" in s[-1], f"(f) terminal chunk {s[-1]}")
        trips = _metrics(addr)["bigdl_llm_watchdog_trips_total"][()]
        check(srv.watchdog_trips == 1 and trips == 1,
              f"(f) trips {srv.watchdog_trips} / {trips}")
        st, b, _ = _http(addr, "POST", "/worker_generate", body[0])
        check(st == 200 and b["output_ids"] == want[0],
              f"(f) after recovery: {st} {b}")
        out["watchdog"] = {
            "timeout_s": HTTP_WATCHDOG_S, "stall_s": 2 * HTTP_WATCHDOG_S,
            "stalled_503_after_s": t_503 - t_stall,
            "healthy_again_after_s": t_ok - t_stall, "trips": trips,
            "terminal_errors": [s[-1]["error"] for s in streams]}
        # (g) the full queue sheds with 503 + Retry-After
        plan = reliability.FaultPlan(seed=1).add(
            "worker.stall", "delay", times=1, delay=HTTP_WATCHDOG_S * 0.4)
        live = srv.submit(prompts[0], new)
        reliability.set_plan(plan)
        _wait(lambda: plan.fired, 60, "(g) the hold")
        fill = [srv.submit(prompts[0][:20], 4) for _ in range(16)]
        st, b, hdrs = _http(addr, "POST", "/worker_generate", body[1])
        for r in [live] + fill:
            r.get(timeout=120)
        reliability.set_plan(None)
        check(st == 503 and int(hdrs.get("retry-after", 0)) >= 1,
              f"(g) full queue: {st} {b} {hdrs}")
        check(srv.watchdog_trips == 1, "(g) the hold tripped the watchdog")
        out["shed"] = {"status": st, "retry_after": hdrs["retry-after"],
                       "body": b}
        check(not srv.errors, f"phase 11 engine errors: {srv.errors}")
    finally:
        reliability.set_plan(None)
        worker.stop()
        srv.stop()
    ok = [k for k, v in out["launches"].items() if v]
    for k in ("int4_matmul_gemv", "int4_matmul_tc",
              "paged_attention_decode_stats", "ragged_prefill_attention_tc"):
        check(k in ok, f"phase 11: {k} never ran: {out['launches']}")
    torch.cuda.empty_cache()
    # (e) the instruments' cost: phase 3's served run, off and on
    runs = []
    for k in range(6):
        on = bool(k % 2)
        (obs.enable if on else obs.disable)()
        flight.enabled = on
        try:
            row, outs = _serve_run(torch, model, [np.asarray(p) for p in
                                                  prompts], new,
                                   f"7B observability {'on' if on else 'off'}",
                                   **SERVE_7B)
        finally:
            obs.enable()
            flight.enabled = False
        check(outs == want, "(e) tokens differ with observability "
              f"{'on' if on else 'off'}")
        runs.append({"observability": on, **{
            x: row[x] for x in ("decode_tok_per_s", "ttft_ms_mean",
                                "decode_step_ms",
                                "host_dispatch_ms_per_step",
                                "drain_wait_ms_per_step")}})
    prof = {on: _pass_profile(torch, model, on) for on in (False, True)}
    for on, p in prof.items():
        check(p["host_launch_calls_by_name"] == {
            "cudaGraphLaunch": 1.0, "cudaMemcpyAsync": 1.0},
            f"(e) host calls a pass, observability {on}: {p}")
    check(prof[True]["kernels_per_pass"] == prof[False]["kernels_per_pass"],
          f"(e) kernels a pass on / off: {prof}")
    out["overhead"] = {"runs": runs, "profile": list(prof.values()),
                       "decode_tok_per_s_on_off": [
                           statistics.mean(r["decode_tok_per_s"] for r in
                                           runs if r["observability"] is b)
                           for b in (True, False)]}
    # (h) the prefill and decode roles: a handoff over HTTP
    tier = dict(SERVE_7B, kvcache=True, kvtier=True, host_pages=64)
    pre, dec = (LLMServer(model, **tier).start() for _ in range(2))
    wp = LLMWorker(pre, role="prefill").start()
    wd = LLMWorker(dec, role="decode").start()
    try:
        for s in (pre, dec):        # the decode graphs captured first
            s.submit(prompts[5][:40], 3).get(timeout=600)
        legs = {}
        t0 = time.perf_counter()
        st, b, _ = _http(wp.address, "POST", "/worker_prefill",
                         {"prompt_ids": prompts[0]})
        legs["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        check(st == 200, f"(h) /worker_prefill: {st} {b}")
        blob_mb = b["handoff_bytes"] / 2**20
        t0 = time.perf_counter()
        st, imp, _ = _http(wd.address, "POST", "/worker_import_chain",
                           {"handoff": b["handoff"]})
        legs["import_ms"] = (time.perf_counter() - t0) * 1e3
        check(st == 200 and imp["imported_pages"] ==
              len(prompts[0]) // 16, f"(h) import: {st} {imp}")
        t0 = time.perf_counter()
        st, g, _ = _http(wd.address, "POST", "/worker_generate", body[0])
        legs["generate_ms"] = (time.perf_counter() - t0) * 1e3
        # the exporter admits the prompt again over the same page bytes:
        # the same prefix hit and one-token suffix prefill
        ref = pre.submit(np.asarray(prompts[0]), new).get(timeout=600)
        check(st == 200 and g["output_ids"] == ref and dec._tier.fetches
              == imp["imported_pages"], f"(h) decode worker {st} {g} "
              f"against the exporter's {ref}, {dec._tier.fetches} fetched")
        check(not pre.errors and not dec.errors,
              f"(h) engine errors: {pre.errors} {dec.errors}")
    finally:
        for x in (wp, wd, pre, dec):
            x.stop()
    out["roles"] = dict(
        legs, blob_mb=blob_mb, pages=imp["imported_pages"],
        ids_equal_exporter_readmission=True,
        ids_equal_a=g["output_ids"] == want[0],
        leading_equal_to_a=_lead(g["output_ids"], want[0]))
    torch.cuda.empty_cache()
    return out


# -- phase 12: the router over two 7B engines ----------------------------------

ROUTER_WATCHDOG_S = 5.0        # each engine's watchdog_timeout
ROUTER_NEW = 64                # (b)'s and (c)'s tokens a request


def _taps(worker):
    """The accepted sockets of ``worker``'s ``/worker_generate_stream``
    calls, in order: the handle a cut needs (closing the listening socket
    does not end a live stream; ``shutdown`` of the accepted one does)."""
    cls = worker._httpd.RequestHandlerClass
    socks, orig = [], cls.do_POST

    def do_post(self):
        if self.path == "/worker_generate_stream":
            socks.append(self.connection)
        return orig(self)

    cls.do_POST = do_post
    return socks


def _journal_log(router):
    """Every journal entry the router adds, and each failover's (entry,
    tokens drained, time): harness-side wrappers over the journal."""
    log = {"entries": [], "failovers": []}
    j = router._journal
    add, fail = j.add, j.record_failover

    def add_w(*a, **k):
        ent = add(*a, **k)
        log["entries"].append(ent)
        return ent

    def fail_w(ent):
        log["failovers"].append((ent, len(ent.tokens), time.monotonic()))
        fail(ent)

    j.add, j.record_failover = add_w, fail_w
    return log


def _idle_free(srv, want, timeout, what):
    """Wait until ``srv`` holds no request and ``want`` free pages."""
    _wait(lambda: not any(srv._slots) and len(srv._free) == want, timeout,
          what)


def _q4_weight_bytes(linears):
    """The bytes of q4_0 weight planes from their shapes alone, as the
    kernel cases' bound counts them: K x N / 2 packed codes and K / 32 x
    N f32 scales a linear, times its launches a forward. Over
    ``SEVEN_B_LINEARS``, what one 7B decode step reads besides the K/V."""
    return sum(c * (k * n // 2 + k // 32 * n * 4) for k, n, _, c in linears)


def serve_router(torch, model, serve, http):
    """Phase 12: ``LLMRouter`` over two ``LLMWorker(role="decode")`` on
    two engines sharing phase 3's model (phase 3's engine settings,
    ``slo=True``, ``watchdog_timeout=5``, flight recorder on)."""
    from concurrent.futures import ThreadPoolExecutor
    import socket

    import numpy as np

    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch import reliability
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.llm.worker import LLMRouter, LLMWorker
    from bigdl_tpu_torch.observability import (compile_recorder, flight,
                                               utilization)
    from bigdl_tpu_torch.utils.conf import conf

    t_phase = time.perf_counter()
    cfg, new = model.config, 32
    prompts = [p.tolist() for p in _phase3_prompts(torch, cfg)]
    want = serve["outputs"]
    out = {"phase": "serve_router", "model": "Llama-2-7B q4_0 (phase 3's "
           "model), two engines on its weights",
           "engine": dict(SERVE_7B, slo=True,
                          watchdog_timeout=ROUTER_WATCHDOG_S)}
    obs.enable()
    flight.enabled = True
    caps0 = {r["fn"]: r["compiles"] for r in compile_recorder.compile_stats()}
    engines = [LLMServer(model, slo=True, watchdog_timeout=ROUTER_WATCHDOG_S,
                         **SERVE_7B) for _ in range(2)]
    for srv in engines:
        _warm_inline(torch, srv, prompts, "phase 12")
    for srv in engines:
        srv.start()
    free0 = [len(s._free) for s in engines]
    workers = [LLMWorker(s, role="decode", federation=True).start()
               for s in engines]
    taps = [_taps(w) for w in workers]
    addrs = [w.address for w in workers]
    body = [{"prompt_ids": p, "max_new_tokens": new} for p in prompts]
    routers, extra = [], []

    def router(*a, **k):
        k.setdefault("start_prober", False)
        r = LLMRouter(*a, **k).start()
        routers.append(r)
        return r

    def concurrent(addr, bodies, path="/worker_generate"):
        t0 = time.perf_counter()

        def one(b):
            t = time.perf_counter()
            st, res, _ = _http(addr, "POST", path, b)
            return st, res, (time.perf_counter() - t) * 1e3
        with ThreadPoolExecutor(len(bodies)) as ex:
            res = list(ex.map(one, bodies))
        return res, time.perf_counter() - t0

    def counter(name, **labels):
        return obs.REGISTRY.sample_value(name, **labels) or 0.0

    def sketch_sum(name):
        m = obs.REGISTRY.get(name)
        return m.sum if m is not None else 0.0

    buckets = [_bucket(len(p), model.page_size) for p in prompts]

    def routed_launches(addr, what):
        """Phase 3's 8 prompts through the router at ``addr``, the launch
        counts zeroed just before and read once both engines are idle:
        exactly each prompt's prefill at its bucket and both engines'
        decode steps. Returns the responses, the wall, the counts and
        the steps."""
        steps0 = [s.steps for s in engines]
        kernels.reset_launch_counts()
        res, wall = concurrent(addr, body)
        for k, s in enumerate(engines):
            _idle_free(s, free0[k], 15, f"{what}: engine {k} idle")
        counts = kernels.launch_counts()
        steps = sum(s.steps - s0 for s, s0 in zip(engines, steps0))
        for i, (st, b, _) in enumerate(res):
            check(st == 200 and b["output_ids"] == want[i],
                  f"{what} request {i}: {st} {b}")
        expect = _path_expect(model, buckets, steps)
        check(counts == expect, f"{what}: launch counts {counts} != "
              f"expected {expect}")
        return res, wall, counts, steps

    try:
        # (a) blocking round-robin: phase 3's ids, both engines serve
        utilization.reset()
        served0 = [w._tokens_out for w in workers]
        t0 = [counter("bigdl_llm_ttft_seconds"),
              sketch_sum("bigdl_llm_ttft_seconds")]
        ra = router([], addrs)
        res, wall, out["launches"], steps_a = routed_launches(ra.address,
                                                              "(a)")
        served = [w._tokens_out - s0 for w, s0 in zip(workers, served0)]
        check(all(served), f"(a) an engine served nothing: {served}")
        ttft_n = counter("bigdl_llm_ttft_seconds") - t0[0]
        ttft_s = sketch_sum("bigdl_llm_ttft_seconds") - t0[1]
        e2e = [ms for _, _, ms in res]
        out["blocking"] = {
            "tokens_by_engine": served, "wall_s": wall,
            "aggregate_tok_per_s": 8 * new / wall,
            "e2e_ms_mean": statistics.mean(e2e), "e2e_ms_max": max(e2e),
            "engine_ttft_ms_mean": ttft_s / ttft_n * 1e3,
            "phase11_direct": {
                "blocking_wall_s": http["blocking"]["wall_s"],
                "blocking_aggregate_tok_per_s":
                    http["blocking"]["aggregate_tok_per_s"],
                "engine_ttft_ms_mean": http["stream"]["engine_ttft_ms_mean"],
                "first_chunk_ms_mean": http["stream"]["first_chunk_ms_mean"]}}
        # (h), first half: the roofline of (a)'s run on each worker's
        # snapshot, its capture records and the gauge
        roofs = []
        for w in workers:
            st, doc, _ = _http(w.address, "GET", "/metrics/snapshot")
            rows = {r["fn"]: r for r in doc.get("roofline", {}).get(
                "programs", [])}
            check(st == 200 and rows.get("llm/decode_paged", {}).get(
                "calls") == steps_a, f"(h) roofline {st} {rows} against "
                f"{steps_a} steps")
            roofs.append(doc["roofline"])
        bw_a = obs.REGISTRY.sample_value("bigdl_device_bw_util")
        check(bw_a is not None and 0 < bw_a <= 1.05,
              f"(h) bigdl_device_bw_util after (a): {bw_a}")
        out["roofline_a"] = {"bw_util": bw_a, "mfu": obs.REGISTRY.sample_value(
            "bigdl_device_mfu"), "hbm_bw_gbps": obs.REGISTRY.sample_value(
            "bigdl_device_hbm_bw_gbps"), "steps": steps_a,
            "table": roofs[0]["programs"]}

        # (b) failover streamed: the same ids, then a mid-stream cut
        rb = router([], addrs, failover=True, slo=True)
        log = _journal_log(rb)
        _, _, out["launches_failover"], _ = routed_launches(rb.address, "(b)")
        req = {"prompt_ids": prompts[0], "max_new_tokens": ROUTER_NEW}
        st, unfailed, _ = _http(rb.address, "POST", "/worker_generate", req)
        check(st == 200, f"(b) unfailed run: {st} {unfailed}")
        unfailed = unfailed["output_ids"]
        n_taps = [len(t) for t in taps]
        fo0 = counter("bigdl_router_failovers_total", stage="decode")
        n_ent = len(log["entries"])
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(_http, rb.address, "POST", "/worker_generate",
                            req)
            _wait(lambda: len(log["entries"]) > n_ent
                  and len(log["entries"][-1].tokens) >= 16, 60,
                  "(b) 16 tokens drained")
            ent = log["entries"][-1]
            cut = next(i for i, t in enumerate(taps) if len(t) > n_taps[i])
            before = list(ent.tokens)
            t_cut = time.monotonic()
            taps[cut][-1].shutdown(socket.SHUT_RDWR)
            st, ans, _ = fut.result()
        check(st == 200 and len(ans["output_ids"]) == ROUTER_NEW,
              f"(b) after the cut: {st} {ans}")
        ans = ans["output_ids"]
        check(ans[:len(before)] == unfailed[:len(before)],
              f"(b) the tokens before the cut {before} against the unfailed "
              f"{unfailed[:len(before)]}")
        fos = [f for f in log["failovers"] if f[0] is ent]
        check(len(fos) == 1, f"(b) {len(fos)} failovers of the cut request")
        n_res = fos[0][1]
        surv = engines[1 - cut]
        direct = surv.submit(np.asarray(prompts[0] + ans[:n_res]),
                             ROUTER_NEW - n_res).get(timeout=120)
        check(ans[n_res:] == direct, f"(b) the resumed suffix {ans[n_res:]} "
              f"against the surviving engine's own {direct}")
        fo_delta = counter("bigdl_router_failovers_total",
                           stage="decode") - fo0
        check(fo_delta == 1, f"(b) bigdl_router_failovers_total +{fo_delta}")
        _idle_free(engines[cut], free0[cut], 10, "(b) the cut engine's pages")
        nxt = next(t for t in ent.token_times if t > t_cut)
        out["failover"] = {
            "cut_engine": cut, "tokens_before_cut": len(before),
            "tokens_resumed": n_res,
            "cut_to_next_token_ms": (nxt - t_cut) * 1e3,
            "equals_surviving_engines_own_answer": True,
            "equals_unfailed_bit_for_bit": ans == unfailed,
            "leading_equal_to_unfailed": _lead(ans, unfailed),
            "failovers_total_delta": fo_delta,
            "cut_engine_free_pages_back": True}

        # (c) a stall of twice the watchdog on engine 1 under 2 streams:
        # the prober marks it, both finish on engine 2
        rc_ = router([], addrs[:1], failover=True, prober_interval=0.25,
                     start_prober=True)
        log = _journal_log(rc_)
        plan = reliability.FaultPlan(seed=0).add(
            "worker.stall", "delay", after=8, times=1,
            delay=2 * ROUTER_WATCHDOG_S)
        reliability.set_plan(plan)
        unhealthy = []
        try:
            with ThreadPoolExecutor(2) as ex:
                futs = [ex.submit(_http, rc_.address, "POST",
                                  "/worker_generate",
                                  {"prompt_ids": prompts[i],
                                   "max_new_tokens": ROUTER_NEW})
                        for i in (2, 3)]
                t_stall = _wait(lambda: plan.fired, 60, "(c) the stall")
                st, _, _ = _http(rc_.address, "POST", "/backends", {
                    "action": "add", "role": "decode",
                    "host": addrs[1][0], "port": addrs[1][1]})
                check(st == 200, f"(c) POST /backends: {st}")
                _wait(lambda: not rc_._prober.healthy(addrs[0]),
                      ROUTER_WATCHDOG_S + 3, "(c) the prober's verdict",
                      every=0.02)
                unhealthy.append(time.monotonic() - t_stall)
                res = [f.result() for f in futs]
            t_ok = _wait(lambda: rc_._prober.healthy(addrs[0]),
                         4 * ROUTER_WATCHDOG_S, "(c) engine 1 healthy again",
                         every=0.05)
        finally:
            reliability.set_plan(None)
        gaps = []
        for k, (st, b, _) in zip((2, 3), res):
            check(st == 200 and len(b["output_ids"]) == ROUTER_NEW
                  and "error" not in b, f"(c) stream {k}: {st} {b}")
            # the journal's entries are in arrival order: match by prompt
            (ent,) = [e for e in log["entries"]
                      if e.prompt_ids == prompts[k]]
            fos = [f for f in log["failovers"] if f[0] is ent]
            check(len(fos) >= 1, f"(c) stream {k} never failed over")
            n_res = fos[-1][1]
            ans = b["output_ids"]
            direct = engines[1].submit(np.asarray(
                prompts[k] + ans[:n_res]), ROUTER_NEW - n_res).get(
                timeout=120)
            check(ans[n_res:] == direct, f"(c) stream {k}'s resumed suffix "
                  f"after {n_res} tokens ({len(fos)} failovers) against "
                  f"engine 2's own answer: {ans[n_res:]} / {direct}")
            times = list(ent.token_times)
            gaps.append(max(b - a for a, b in zip(times, times[1:])))
        check(engines[0].watchdog_trips >= 1, "(c) no watchdog trip")
        out["stall"] = {
            "stall_s": 2 * ROUTER_WATCHDOG_S,
            "prober_unhealthy_after_s": unhealthy[0],
            "healthy_again_after_s": t_ok - t_stall,
            "client_visible_stall_s": gaps,
            "engine1_trips": engines[0].watchdog_trips,
            "failovers": rc_.failovers}
        for k, s in enumerate(engines):
            _idle_free(s, free0[k], 30, f"(c) engine {k} idle")

        # (d) hedging at budget 1.0: (a)'s ids, every page back
        h0 = {o: counter("bigdl_router_hedges_total", stage="decode",
                         outcome=o)
              for o in ("issued", "primary_won", "hedge_won")}
        conf.set("bigdl.llm.hedge.budget", "1.0")
        try:
            rd = router([], addrs, failover=True, hedge=True,
                        hedge_delay_ms=1.0)
        finally:
            conf.unset("bigdl.llm.hedge.budget")
        res, wall = concurrent(rd.address, body)
        for i, (st, b, _) in enumerate(res):
            check(st == 200 and b["output_ids"] == want[i],
                  f"(d) request {i}: {st} {b}")
        hedges = {o: counter("bigdl_router_hedges_total", stage="decode",
                             outcome=o) - h0[o] for o in h0}
        check(hedges["issued"] >= 1, f"(d) no hedge issued: {hedges}")
        for k, s in enumerate(engines):
            _idle_free(s, free0[k], 15, f"(d) engine {k}'s pages")
        out["hedge"] = {"hedges": hedges, "wall_s": wall,
                        "free_pages_back": True}

        # (g) the OpenAI gateway on the router: (a)'s ids, exact usage
        rg = router([], addrs, failover=True, api=True)
        st, b, _ = _http(rg.address, "POST", "/v1/completions",
                         {"model": "bigdl-tpu-llm", "prompt": prompts[0],
                          "max_tokens": new})
        usage = {"prompt_tokens": len(prompts[0]), "completion_tokens": new,
                 "total_tokens": len(prompts[0]) + new}
        check(st == 200 and b["choices"][0]["token_ids"] == want[0]
              and b["usage"] == usage, f"(g) /v1/completions: {st} {b}")
        out["api"] = {"ids_equal_a": True, "usage": b["usage"]}

        # (h), second half: phase 3's run on one engine, the gauge read
        # over its decode window, against phase 3's reckoned bytes a step
        # over its measured step ms
        reqs = [engines[0].submit(np.asarray(p), new) for p in prompts]
        _wait(lambda: all(r.tokens for r in reqs), 60, "(h) first tokens")
        utilization.reset()
        lens = [len(r.tokens) for r in reqs]
        outs = [r.get(timeout=120) for r in reqs]
        check(outs == want, "(h) phase 3's ids on one engine")
        bw = obs.REGISTRY.sample_value("bigdl_device_bw_util")
        kv_key = 2 * cfg.num_hidden_layers * cfg.num_key_value_heads \
            * cfg.head_dim * 2
        # the window's mean keys a step: each row from its length at the
        # reset to its last token
        keys = sum(len(p) + (k + new) / 2 for p, k in zip(prompts, lens))
        step_b = _q4_weight_bytes(SEVEN_B_LINEARS) + kv_key * keys
        expect = step_b / (serve["decode_step_ms"] / 1e3) / HBM_BYTES_PER_S
        check(bw is not None and 0 < bw <= 1.05
              and abs(bw / expect - 1) <= 0.25,
              f"(h) bigdl_device_bw_util {bw} against phase 3's {expect}")
        out["roofline"] = {
            "bw_util": bw, "phase3_expect": expect,
            "phase3_bytes_per_step": step_b,
            "phase3_decode_step_ms": serve["decode_step_ms"],
            "mfu": obs.REGISTRY.sample_value("bigdl_device_mfu"),
            "hbm_bw_gbps": obs.REGISTRY.sample_value(
                "bigdl_device_hbm_bw_gbps"),
            "table": utilization.roofline_table()}

        # (e) the two-stage route over host-tier engines
        tier = dict(SERVE_7B, kvcache=True, kvtier=True, host_pages=64)
        pre, dec = (LLMServer(model, **tier).start() for _ in range(2))
        wp = LLMWorker(pre, role="prefill").start()
        wd = LLMWorker(dec, role="decode").start()
        extra += [wp, wd, pre, dec]
        for s in (pre, dec):        # the decode graphs captured first
            s.submit(prompts[5][:40], 3).get(timeout=600)
        re_ = router([wp.address], [wd.address], failover=True)
        legs = {}
        for name in ("_call", "_stream_decode"):
            fn = getattr(re_, name)

            def timed(*a, _fn=fn, _name=name, **k):
                t = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    key = a[1] if _name == "_call" else "decode stream"
                    legs[key] = (time.perf_counter() - t) * 1e3
            setattr(re_, name, timed)
        st, g, _ = _http(re_.address, "POST", "/worker_generate", body[0])
        ref = pre.submit(np.asarray(prompts[0]), new).get(timeout=600)
        check(st == 200 and g["output_ids"] == ref and re_.handoffs_routed
              == 1 and dec._tier.fetches >= 1, f"(e) {st} {g} against the "
              f"exporter's {ref}, {dec._tier.fetches} fetched")
        out["two_stage"] = {"legs_ms": legs, "ids_equal_a":
                            g["output_ids"] == want[0],
                            "ids_equal_exporter_readmission": True}

        # (f) federation: the merged view and a stopped member
        conf.set("bigdl.observability.federation.interval", "0.25")
        try:
            rf = router([], addrs, federation=True, failover=True)
        finally:
            conf.unset("bigdl.observability.federation.interval")
        rf._collector.collect_now()
        merged = _metrics(rf.address)
        name = "bigdl_llm_decode_tokens_total"
        per = [sum(s["value"] for d in snap["metrics"] if d["name"] == name
                   for s in d["series"])
               for snap in rf._collector.snapshots().values()]
        check(merged[name][()] == sum(per) and len(per) == 3,
              f"(f) merged {merged[name]} against the members' {per}")
        st, status, _ = _http(rf.address, "GET", "/fleet/status")
        check(st == 200 and set(status["members"]) == {
            f"{a[0]}:{a[1]}" for a in addrs}, f"(f) /fleet/status {status}")
        workers[1].stop()
        t_stop = time.monotonic()
        key = f"{addrs[1][0]}:{addrs[1][1]}"
        t_stale = _wait(lambda: rf._collector.status()["members"][key][
            "stale"], 10, "(f) the stopped member stale", every=0.01)
        check(t_stale - t_stop <= 2 * rf._collector.interval,
              f"(f) stale {t_stale - t_stop:.3f} s after the stop")
        out["federation"] = {
            "merged_decode_tokens": merged[name][()], "members": per,
            "stale_after_s": t_stale - t_stop,
            "interval_s": rf._collector.interval}
        for e in engines + [pre, dec]:
            check(not e.errors, f"phase 12 engine errors: {e.errors}")
        # the roofline hook's host cost, which the engine thread pays once
        # a drained step with the flight recorder on: one observe over a
        # full window of 7B decode entries, on this host
        entry = ("llm/decode_paged", serve["decode_step_ms"] / 1e3,
                 (int(keys), int(keys)))
        for _ in range(utilization.WINDOW):
            utilization.observe(*entry)
        t = time.perf_counter()
        for _ in range(200):
            utilization.observe(*entry)
        out["roofline"]["observe_us_full_window"] = (
            time.perf_counter() - t) / 200 * 1e6
        utilization.reset()
        rec = {r["fn"]: r for r in compile_recorder.compile_stats()}.get(
            "llm/decode_paged", {"compiles": 0, "history": []})
        n_cap = rec["compiles"] - caps0.get("llm/decode_paged", 0)
        check(n_cap == 4, f"(h) {n_cap} capture records for 4 engines' "
              "decode steps")
        hist = rec["history"][-n_cap:] if n_cap else []
        out["captures"] = {"llm/decode_paged": {
            "captures": n_cap, "capture_s": [h["capture_s"] for h in hist],
            "pool_mb": [h["pool_bytes"] / 2**20 for h in hist],
            "launches_per_replay": {
                k: v for k, v in hist[0]["launches"].items() if v}
            if hist else None}}
    finally:
        reliability.set_plan(None)
        for r in routers:
            r.stop()
        for x in workers + extra + engines:
            x.stop()
        flight.enabled = False
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# -- phase 13: the time-series plane, alerts, the elastic fleet, the converter,
#    the CLI and the LangChain wrappers ----------------------------------------

PLANE_INTERVAL_S = 0.25        # the time-series sampler's cadence
ALERT_RULE = {"name": "ttft-burn", "kind": "burn_rate", "slo": "ttft",
              "short": 2.0, "long": 4.0, "factor": 2.0, "objective": 0.99}
FLEET_OPTS = dict(min_workers=1, max_workers=2, interval=0.1, sustain=2,
                  cooldown=2.0, queue_high=2.0, idle_low=0.0,
                  drain_timeout=60.0)
FLEET_P_LEN = 480              # (c)'s prompt held by the drained engine only


class _FrozenHeap:
    """The heap that the phases before left (their models, traces and
    records), collected once and then frozen out of the cycle collector's
    passes, as a server freezes its heap after warm-up: a full pass over
    it holds the GIL, so the engine's thread would stall for as long and
    a clean request could miss the TTFT objective that (b) judges. Every
    collector pass inside the block is recorded, with its ms."""

    def __enter__(self):
        import gc
        self.objects = len(gc.get_objects())
        t = time.perf_counter()
        gc.collect()
        self.collect_ms = (time.perf_counter() - t) * 1e3
        gc.freeze()
        self.frozen = gc.get_freeze_count()
        self.passes, self._t = [], None
        gc.callbacks.append(self._on_gc)
        return self

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.passes.append((info["generation"],
                                (time.perf_counter() - self._t) * 1e3))

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._on_gc)
        gc.unfreeze()
        return False

    def record(self):
        return {"objects_before": self.objects,
                "collect_ms_before": self.collect_ms,
                "frozen_objects": self.frozen,
                "passes_by_generation": [
                    sum(1 for g, _ in self.passes if g == k)
                    for k in range(3)],
                "pass_ms_max": max((ms for _, ms in self.passes),
                                   default=0.0)}


def _plane_conf(on, interval=PLANE_INTERVAL_S):
    """The time-series plane's gate and cadence in the port's config."""
    from bigdl_tpu_torch.utils.conf import conf
    keys = ("bigdl.observability.timeseries.enabled",
            "bigdl.observability.timeseries.interval")
    if on:
        conf.set(keys[0], "true")
        conf.set(keys[1], str(interval))
    else:
        for k in keys:
            conf.unset(k)


def _plane_profile(torch, model, on):
    """:func:`_pass_profile` (observability on) with the time-series
    plane on or off; on, the sampler ticks every 10 ms so that samples
    fall inside the traced window."""
    from bigdl_tpu_torch.observability import timeseries
    _plane_conf(on, 0.01)
    st = timeseries.acquire()
    try:
        n0 = st.samples_total if st is not None else 0
        row = _pass_profile(torch, model, True)
        row["samples_during"] = (st.samples_total - n0
                                 if st is not None else 0)
    finally:
        if st is not None:
            timeseries.release()
        _plane_conf(False)
        timeseries.reset()
    row["timeseries"] = on
    return row


def _plane_and_alerts(torch, model, serve, http):
    """Phase 13 (a) and (b): the time-series plane's cost on phase 3's
    served run, its queries against the engine's own sketch, and one
    burn-rate alert fired and resolved by a storm of ``llm.step``
    delays."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch import reliability
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.llm.worker import LLMWorker
    from bigdl_tpu_torch.observability import alerts, flight, timeseries
    from bigdl_tpu_torch.utils.conf import conf

    cfg, new = model.config, 32
    prompts = [p.tolist() for p in _phase3_prompts(torch, cfg)]
    want = serve["outputs"]
    out = {}
    obs.enable()
    timeseries.reset()
    alerts.reset()
    # (a) phase 3's served run 3 times each with the plane off and on,
    # alternating (each run's engine acquires the sampler when on)
    runs = []
    for k in range(6):
        on = bool(k % 2)
        _plane_conf(on)
        n0 = getattr(timeseries.store(), "samples_total", 0)
        try:
            row, outs = _serve_run(
                torch, model, [np.asarray(p) for p in prompts], new,
                f"7B time-series plane {'on' if on else 'off'}", slo=True,
                **SERVE_7B)
            samples = getattr(timeseries.store(), "samples_total", 0) - n0
        finally:
            _plane_conf(False)
        check(outs == want, "(a) tokens differ with the plane "
              f"{'on' if on else 'off'}")
        check((samples > 0) == on, f"(a) {samples} samples, plane {on}")
        runs.append({"timeseries": on, "samples": samples, **{
            x: row[x] for x in ("decode_tok_per_s", "ttft_ms_mean",
                                "decode_step_ms",
                                "host_dispatch_ms_per_step",
                                "drain_wait_ms_per_step")}})
    timeseries.reset()
    prof = {on: _plane_profile(torch, model, on) for on in (False, True)}
    phase11 = http["overhead"]["profile"][-1]          # observability on
    for on, p in prof.items():
        check(p["host_launch_calls_by_name"] == {
            "cudaGraphLaunch": 1.0, "cudaMemcpyAsync": 1.0}
            and p["kernels_per_pass"] == phase11["kernels_per_pass"],
            f"(a) a graphed pass with the plane {on}: {p} against phase "
            f"11's {phase11}")
    check(prof[True]["samples_during"] > 0, "(a) no sample in the window")
    # one sample over the live registry (every series the phases before
    # minted), and the alert engine's evaluation behind it
    _plane_conf(True, 3600.0)
    st = timeseries.acquire()
    try:
        cost = []
        for _ in range(25):
            t = time.perf_counter()
            st.sample_now()
            cost.append((time.perf_counter() - t) * 1e6)
        snap_us = st.last_overhead_us
        n_series = len(st._samples[-1][1][st.local_instance()]["metrics"])
    finally:
        timeseries.release()
        _plane_conf(False)
        timeseries.reset()
        alerts.reset()
    out["overhead"] = {
        "interval_s": PLANE_INTERVAL_S, "runs": runs,
        "profile": list(prof.values()),
        "decode_tok_per_s_on_off": [
            statistics.mean(r["decode_tok_per_s"] for r in runs
                            if r["timeseries"] is b) for b in (True, False)],
        "host_dispatch_ms_per_step_on_off": [
            statistics.mean(r["host_dispatch_ms_per_step"] for r in runs
                            if r["timeseries"] is b) for b in (True, False)],
        "sample_now_us_median_of_25": statistics.median(cost),
        "snapshot_us_last": snap_us, "registry_metrics": n_series}

    # (b) one burn-rate rule over the engine's TTFT verdicts
    target_ms = 3 * serve["ttft_ms_mean"]
    rule = dict(ALERT_RULE)
    conf.set("bigdl.slo.ttft_ms", str(target_ms))
    conf.set("bigdl.observability.alerts.rules", json.dumps([rule]))
    _plane_conf(True)
    flight.enabled = True
    srv = LLMServer(model, slo=True, watchdog_timeout=HTTP_WATCHDOG_S,
                    **SERVE_7B)
    _warm_inline(torch, srv, prompts, "phase 13 (b)")
    worker = None
    heap = _FrozenHeap().__enter__()
    try:
        srv.start()
        worker = LLMWorker(srv).start()
        addr = worker.address
        st, eng = timeseries.store(), alerts.engine()
        check(st is not None and eng is not None and eng.rules == [rule],
              "(b) the plane did not build its store and rule")
        trail, name = [], rule["name"]

        def on_sample(now):
            pts = st.points("bigdl_slo_requests_total",
                            {"slo": "ttft", "verdict": "violated"},
                            window=0.0, now=now)
            trail.append((now, pts[-1][2] if pts else 0.0,
                          eng.status()["rules"][0]["state"]))
        st.on_sample.append(on_sample)

        def count(state):
            return obs.REGISTRY.sample_value(
                "bigdl_alerts_transitions_total", rule=name,
                state=state) or 0.0

        def fl(kind):
            ring = flight.ring()
            return [e for e in (ring.events() if ring else [])
                    if e["kind"] == kind
                    and e.get("detail", {}).get("rule") == name]
        c0 = {s: count(s) for s in ("firing", "resolved")}
        f0 = {k: len(fl(k)) for k in ("alert_fire", "alert_resolve")}

        walls = []                      # (wall time, TTFT ms) a request

        def clean(seconds):
            """One short request every 0.5 s (few enough that one
            violation in the long window burns past the factor)."""
            t_end = time.monotonic() + seconds
            ttft = []
            while time.monotonic() < t_end:
                t = time.monotonic()
                r = srv.submit(prompts[0], 4)
                r.get(timeout=60)
                ttft.append((r.t_first_token - r.t_submit) * 1e3)
                walls.append((time.time(), ttft[-1]))
                time.sleep(max(0.0, 0.5 - (time.monotonic() - t)))
            return ttft

        clean_ttft = clean(4.5)
        check(all(s != "firing" for _, _, s in trail),
              f"(b) the rule fired on clean traffic: {trail[-4:]}")
        check(max(clean_ttft) < target_ms,
              f"(b) clean TTFT {max(clean_ttft):.1f} ms over the "
              f"{target_ms:.1f} ms target")
        n_clean = len(trail)
        v0 = trail[-1][1]               # earlier phases' violations
        delay = 1.2 * target_ms / 1e3 + 0.05
        plan = reliability.FaultPlan(seed=0).add("llm.step", "delay",
                                                 times=None, delay=delay)
        t_storm = time.time()
        reliability.set_plan(plan)
        with ThreadPoolExecutor(2) as ex:
            storm = list(ex.map(lambda i: srv.submit(prompts[i], 1),
                                range(2)))
            for r in storm:
                r.get(timeout=120)
        reliability.set_plan(None)
        # the engine's loop injects at every pass, idle ones too: a delay
        # drawn just before the disarm still runs and would hold the first
        # clean request past the objective, so the storm ends when the
        # loop next beats
        t_off = time.monotonic()
        while srv._hb <= t_off and time.monotonic() - t_off < 30:
            time.sleep(0.005)
        storm_tail = time.monotonic() - t_off
        check(srv._hb > t_off, "(b) the engine did not beat within 30 s "
              "of the disarm")
        t_calm = time.time()
        storm_ttft = [(r.t_first_token - r.t_submit) * 1e3 for r in storm]
        check(min(storm_ttft) > target_ms, f"(b) storm TTFTs {storm_ttft}")
        t_fire = None
        t0 = time.monotonic()
        while t_fire is None and time.monotonic() - t0 < 10:
            hit = [(ts, v, s) for ts, v, s in trail[n_clean:] if v > v0]
            if hit:
                t_fire = hit[0]
            time.sleep(0.05)
        check(t_fire is not None and t_fire[2] == "firing",
              f"(b) the first sample after a violation did not fire: "
              f"{trail[n_clean:]}")
        resolve_ttft = clean(rule["long"] + 3.0)
        res = [(ts, v, s) for ts, v, s in trail if s == "resolved"]
        check(res, f"(b) never resolved: {trail[-6:]}")
        # a firing burn rule needs both windows over the factor, so it
        # resolves once the SHORT window holds no violation: within
        # ``short`` (and a sample or two) of the last violating sample
        v_end = max(v for ts, v, s in trail if ts <= res[0][0])
        t_last_bad = min(ts for ts, v, s in trail if v == v_end)
        lag = res[0][0] - t_last_bad
        check(lag <= rule["short"] + 3 * PLANE_INTERVAL_S,
              f"(b) resolved {lag:.2f} s after the last violating sample")
        st_, body, _ = _http(addr, "GET", "/alerts")
        r0 = body["rules"][0] if st_ == 200 else {}
        transitions = {s: count(s) - c0[s] for s in ("firing", "resolved")}
        slow = [w for w in walls if w[1] > target_ms]
        events = {k: len(fl(k)) - f0[k] for k in ("alert_fire",
                                                  "alert_resolve")}
        check(transitions == {"firing": 1.0, "resolved": 1.0}
              and events == {"alert_fire": 1, "alert_resolve": 1}
              and r0.get("state") == "resolved"
              and r0.get("fired_count") == 1
              and r0.get("last_fired") == t_fire[0]
              and r0.get("last_resolved") == res[0][0],
              f"(b) transitions {transitions}, flight {events}, /alerts "
              f"{st_} {r0}, fire {t_fire}, resolve {res[0]}, clean "
              f"requests over the target {slow}, collector "
              f"{heap.record()}")
        out["alerts"] = {
            "rule": rule, "slo_ttft_ms": target_ms,
            "phase3_ttft_ms_mean": serve["ttft_ms_mean"],
            "storm_delay_s_per_pass": delay,
            "clean_ttft_ms_max": max(clean_ttft + resolve_ttft),
            "storm_ttft_ms": storm_ttft,
            "disarm_to_next_pass_s": storm_tail,
            "storm_to_firing_s": t_fire[0] - t_storm,
            "storm_end_to_resolved_s": res[0][0] - t_calm,
            "last_violation_to_resolved_s": lag,
            "samples": len(trail), "transitions": transitions,
            "flight_events": events, "alerts_body": r0,
            "collector": heap.record()}

        # (a) the store's windows against the engine's own sketch: idle a
        # second, a sample, phase 3's 8 prompts over HTTP, a sample
        sk = obs.REGISTRY.get("bigdl_llm_ttft_seconds")
        time.sleep(1.2)
        t_pre = timeseries.sample_now()
        pre = sk.to_snapshot()
        body = [{"prompt_ids": p, "max_new_tokens": new} for p in prompts]
        with ThreadPoolExecutor(8) as ex:
            res_a = list(ex.map(lambda b: _http(addr, "POST",
                                                "/worker_generate", b), body))
        t_post = timeseries.sample_now()
        post = sk.to_snapshot()
        for i, (code, b, _) in enumerate(res_a):
            check(code == 200 and b["output_ids"] == want[i],
                  f"(a) request {i}: {code} {b}")
        window = t_post - t_pre + 1.0
        q = {}
        for key, path in (
                ("p99", "/metrics/query?series=bigdl_llm_ttft_seconds"
                        f"&fn=p99&window={window}"),
                ("tokens", "/metrics/query?series=bigdl_llm_decode_tokens_"
                           f"total&fn=delta&window={window}"),
                ("timeline", "/fleet/timeline?series=bigdl_llm_decode_"
                             f"tokens_total&window={window}")):
            code, q[key], _ = _http(addr, "GET", path)
            check(code == 200, f"(a) {path}: {code} {q[key]}")
        p99 = timeseries.sketch_window(pre, post, (0.99,))[0.99]
        check(q["p99"]["value"] == p99 and q["tokens"]["value"] == 8 * new,
              f"(a) /metrics/query p99 {q['p99']} against the sketch's "
              f"{p99}; tokens {q['tokens']} against {8 * new}")
        out["queries"] = {"window_s": window, "ttft_p99_s": p99,
                          "ttft_p99_query": q["p99"],
                          "decode_tokens_delta": q["tokens"]["value"],
                          "timeline_points": len(
                              q["timeline"]["merged"])}
        check(not srv.errors, f"phase 13 (b) engine errors: {srv.errors}")
    finally:
        heap.__exit__(None, None, None)
        reliability.set_plan(None)
        if worker is not None:
            worker.stop()
        srv.stop()
        _plane_conf(False)
        for k in ("bigdl.slo.ttft_ms", "bigdl.observability.alerts.rules"):
            conf.unset(k)
        timeseries.reset()
        alerts.reset()
        flight.enabled = False
    return out


def _fleet_run(torch, model, serve):
    """Phase 13 (c): ``LLMRouter(failover=True, federation=True,
    fleet=True)`` over a provider of phase 3's engines (one set of
    weights), its controller ticked here at its interval: scale-out under
    a routed burst, a prompt routed to the new engine, scale-in with its
    drain, and the survivor's prefix hit, routed. Each segment's launch
    counts, zeroed just before it and read once every engine is idle, are
    held exactly to what its prefills (the flight recorder's ``admit``
    events: prompt less cached tokens) and decode steps must launch. The
    drain is read from the shipped instruments: the controller's events,
    the ``worker/drain``, ``fleet/scale`` and ``llm/handoff_import``
    spans, the ``drain_migrate`` flight events and the ``bigdl_fleet_*``
    series. Then one scale-out and scale-in by the shipped
    ``LocalWorkerProvider`` under the controller's own thread, its engine
    un-warmed with the watchdog on."""
    from concurrent.futures import ThreadPoolExecutor

    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.fleet import LocalWorkerProvider
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.llm.worker import LLMRouter, LLMWorker
    from bigdl_tpu_torch.observability import flight, tracing
    from bigdl_tpu_torch.utils.conf import conf

    cfg, new, page = model.config, 32, model.page_size
    prompts = [p.tolist() for p in _phase3_prompts(torch, cfg)]
    want = serve["outputs"]
    engine_kw = dict(SERVE_7B, kvcache=True, kvtier=True, host_pages=192,
                     slo=True, watchdog_timeout=HTTP_WATCHDOG_S)
    # one prompt a prefill bucket of phase 3's (32..512): every bucket
    # warm, and fewer warm-up chains for the drain to migrate
    warm, seen = [], set()
    for p_ in prompts:
        if _bucket(len(p_), page) not in seen:
            seen.add(_bucket(len(p_), page))
            warm.append(p_)
    engines, launched = {}, []       # every engine of (c), kept once stopped

    class WarmProvider(LocalWorkerProvider):
        """Each launch builds the engine, warms every bucket inline
        (graph capture included) before ``start()``, and serves it."""

        def launch(self):
            t0 = time.time()
            srv = LLMServer(self.model, **self.server_kwargs)
            torch.cuda.synchronize()
            t1 = time.time()
            _warm_inline(torch, srv, warm, "phase 13 (c) launch")
            torch.cuda.synchronize()
            t2 = time.time()
            warm_steps = srv.steps
            srv.start()
            w = LLMWorker(srv, role="decode", fleet=True,
                          federation=True).start()
            addr = tuple(w.address)
            with self._lock:
                self._pairs[addr] = (srv, w)
                self.launches += 1
            engines[addr] = srv
            launched.append({"addr": addr, "t0": t0, "build_s": t1 - t0,
                             "warm_s": t2 - t1, "warm_steps": warm_steps,
                             "decode_capture_s":
                                 srv._decode.capture_seconds})
            return addr

    def idle():
        return all(e.engine_idle() for e in engines.values())

    def events(kind, s0):
        return [e for e in flight.ring().events(kind) if e["seq"] > s0["seq"]]

    def spans(name, s0, **args):
        return [r for r in tracing.TRACE.spans() if r["name"] == name
                and r["ts"] >= s0["t"] * 1e6 and all(
                    r["args"].get(k) == v for k, v in args.items())]

    def begin():
        """Zero the counts; note the flight ring's last event, the wall
        clock and each engine's decode steps so far."""
        ev = flight.ring().events()
        s0 = {"seq": ev[-1]["seq"] if ev else 0, "t": time.time(),
              "steps": {a: e.steps for a, e in engines.items()}}
        kernels.reset_launch_counts()
        return s0

    def end(s0, what):
        """Once every engine is idle: the segment's launch counts held to
        exactly its prefills at their buckets and its decode steps."""
        _wait(idle, 60, f"{what}: engines idle")

        def steps():
            return sum(e.steps - s0["steps"].get(a, 0)
                       for a, e in engines.items())
        n = steps()
        counts = kernels.launch_counts()
        check(steps() == n, f"{what}: a step ran after the engines idled")
        ev = flight.ring().events()
        check(ev and ev[0]["seq"] <= s0["seq"] + 1,
              f"{what}: the flight ring dropped this segment's events")
        admits = events("admit", s0)
        buckets = [_bucket(e["detail"]["prompt_tokens"]
                           - e["detail"]["matched_tokens"], page)
                   for e in admits]
        expect = _path_expect(model, buckets, n)
        check(counts == expect, f"{what}: launch counts {counts} != "
              f"expected {expect} ({len(buckets)} prefills, {n} steps)")
        return {"launches": counts, "prefills": len(buckets),
                "prefill_buckets": sorted(buckets), "decode_steps": n}

    def routed(addr, prompt, n, what):
        """One blocking request through the router at ``addr``: its ids,
        the engine that served it (the one whose decode steps moved), and
        its ``admit`` and ``finish`` flight events (cached tokens, TTFT)."""
        s0 = {"seq": flight.ring().events()[-1]["seq"],
              "steps": {a: e.steps for a, e in engines.items()}}
        st, b, _ = _http(addr, "POST", "/worker_generate",
                         {"prompt_ids": [int(t) for t in prompt],
                          "max_new_tokens": n})
        check(st == 200 and len(b.get("output_ids", ())) == n,
              f"{what}: {st} {b}")
        _wait(idle, 60, f"{what}: engines idle")
        moved = [a for a, e in engines.items() if e.steps != s0["steps"][a]]
        adm, fin = events("admit", s0), events("finish", s0)
        check(len(moved) == 1 and len(adm) == len(fin) == 1,
              f"{what}: engines {moved}, admits {adm}, finishes {fin}")
        return {"ids": b["output_ids"], "engine": moved[0],
                "cached_tokens": adm[0]["detail"]["matched_tokens"],
                "ttft_ms": fin[0]["detail"]["ttft_ms"]}

    def series(name, **labels):
        return obs.REGISTRY.sample_value(name, **labels) or 0.0

    def burst(addr, n_req, until=None, what=""):
        """Phase 3's prompts ``n_req`` at once through the router, while
        ``until`` (ticking the controller here) runs; every answer must be
        that prompt's one-engine answer."""
        body = [{"prompt_ids": prompts[i % 8], "max_new_tokens": new}
                for i in range(n_req)]
        with ThreadPoolExecutor(n_req) as ex:
            futs = [ex.submit(_http, addr, "POST", "/worker_generate", b)
                    for b in body]
            if until is not None:
                until()
            res = [f.result() for f in futs]
        for i, (code, b, _) in enumerate(res):
            check(code == 200 and b["output_ids"] == want[i % 8],
                  f"{what} request {i}: {code} {b}")

    obs.enable()
    flight.enabled = True
    torch.cuda.reset_peak_memory_stats()
    provider = WarmProvider(model, server_kwargs=engine_kw)
    router = router2 = provider2 = None
    out = {"engine": dict(engine_kw), "fleet_opts": FLEET_OPTS}
    try:
        seed = provider.launch()
        flight.set_capacity(1 << 16)
        conf.set("bigdl.observability.federation.interval", "0.1")
        try:
            router = LLMRouter([], [seed], failover=True, federation=True,
                               fleet=True, provider=provider,
                               fleet_opts=FLEET_OPTS, start_fleet=False)
        finally:
            conf.unset("bigdl.observability.federation.interval")
        fc = router._fleet
        router.start()
        ra = router.address
        marks = {"pressure": None}

        def ticks(done, timeout, what):
            """The controller's ticks at its interval, from this thread,
            until ``done()``."""
            t0 = time.monotonic()
            while not done():
                check(time.monotonic() - t0 < timeout, f"{what}: timed out")
                fc.tick()
                d = fc.decisions[-1] if fc.decisions else {}
                if d.get("pressure") and marks["pressure"] is None:
                    marks["pressure"] = time.time()
                time.sleep(fc.interval)

        # A: scale-out under phase 3's prompts 4 times at once
        s0 = begin()
        burst(ra, 32, lambda: ticks(lambda: fc.scale_outs >= 1, 90,
                                    "(c) scale-out"), "(c) burst")
        seg = {"burst": end(s0, "(c) the routed burst and scale-out")}
        peak2 = torch.cuda.max_memory_allocated()
        check(len(launched) == 2 and len(router.decode_workers) == 2
              and marks["pressure"], f"(c) launches {launched} {marks}")
        victim, new_eng = launched[1]["addr"], launched[1]
        out_span = spans("fleet/scale", s0, direction="out")
        check(len(out_span) == 1, f"(c) fleet/scale out spans {out_span}")
        joined = (out_span[0]["ts"] + out_span[0]["dur"]) / 1e6
        # the new engine's warm-up, inside the burst's window
        seg["burst"]["new_engine_warmup"] = _path_expect(
            model, [_bucket(len(p_), page) for p_ in warm],
            new_eng["warm_steps"])
        # B: a prompt routed to the new engine only, cold then again; the
        # fillers (short prompts) take the seed's turns of the round-robin
        gen = torch.Generator().manual_seed(13)
        p = torch.randint(0, cfg.vocab_size, (FLEET_P_LEN,), generator=gen)
        fillers = [torch.randint(0, cfg.vocab_size, (24,), generator=gen)
                   for _ in range(3)]
        s0 = begin()
        f0 = routed(ra, fillers[0], 4, "(c) filler")
        if f0["engine"] == victim:
            routed(ra, fillers[1], 4, "(c) filler")
        cold = routed(ra, p, 8, "(c) cold")
        f2 = routed(ra, fillers[2], 4, "(c) filler")
        again = routed(ra, p, 8, "(c) again")
        check(cold["engine"] == again["engine"] == victim
              and f2["engine"] == seed and cold["cached_tokens"] == 0
              and again["cached_tokens"] > 0,
              f"(c) the prompt's turns: cold {cold}, filler {f2}, "
              f"again {again}")
        seg["two_engines"] = end(s0, "(c) routed to two engines")
        # C: scale-in when idle; the drain launches no kernel
        c0 = {k: series(f"bigdl_fleet_{k}", **lb) for k, lb in (
            ("chains_migrated_total", {}),
            ("drains_total", {"outcome": "drained"}),
            ("scale_events_total", {"direction": "in"}))}
        s0 = begin()
        ticks(lambda: fc.scale_ins >= 1, 90, "(c) scale-in")
        seg["drain"] = end(s0, "(c) the drain")
        acts = [e["action"] for e in fc.status()["events"]]
        drain = spans("worker/drain", s0)
        imports = spans("llm/handoff_import", s0)
        moved = events("drain_migrate", s0)
        fl = {k: series(f"bigdl_fleet_{k}", **lb) - c0[k] for k, lb in (
            ("chains_migrated_total", {}),
            ("drains_total", {"outcome": "drained"}),
            ("scale_events_total", {"direction": "in"}))}
        a = drain[0]["args"] if len(drain) == 1 else {}
        states = (["draining"] * ("drain_begun" in acts)
                  + ["migrating"] * bool(moved) + [a.get("state")])
        pages = sum(e["detail"]["pages"] for e in moved)
        check(states == ["draining", "migrating", "drained"]
              and a.get("chains") == len(moved) == len(imports)
              == fl["chains_migrated_total"] >= 1
              and a.get("pages") == pages and a.get("failed") == 0
              and fl["drains_total"] == fl["scale_events_total"] == 1
              and acts[-2:] == ["drain_begun", "scale_in"],
              f"(c) drain: states {states}, span {drain}, migrate events "
              f"{moved}, imports {len(imports)}, series {fl}, events {acts}")
        check(router.decode_workers == [seed] and fc.drains_lost == 0
              and victim not in provider.servers()
              and series("bigdl_fleet_workers") == 1,
              f"(c) pool {router.decode_workers}, lost {fc.drains_lost}")
        # D: the survivor's prefix hit on the migrated chain, routed
        s0 = begin()
        hot = routed(ra, p, 8, "(c) survivor hit")
        seg["survivor_hit"] = end(s0, "(c) the survivor's hit")
        check(hot["engine"] == seed and hot["cached_tokens"] > 0
              and hot["ids"] == again["ids"],
              f"(c) survivor {hot} against the drained engine's "
              f"re-admission {again}")
        check(router.failovers == 0, f"(c) {router.failovers} failovers")
        st, status, _ = _http(ra, "GET", "/fleet/autoscaler")
        check(st == 200 and status["scale_outs"] == 1
              and status["scale_ins"] == 1, f"(c) autoscaler {status}")
        router.stop()
        router = None
        kv_bytes = (2 * cfg.num_hidden_layers * page * cfg.num_key_value_heads
                    * cfg.head_dim * model.cache_dtype.itemsize)
        out.update({
            "requests": 37 + (f0["engine"] == victim), "lost": 0,
            "failovers": 0,
            "scale_out": {
                "pressured_tick_to_joined_s": joined - marks["pressure"],
                "pressured_tick_to_launch_s": new_eng["t0"]
                - marks["pressure"],
                "engine_build_s": new_eng["build_s"],
                "warm_and_capture_s": new_eng["warm_s"],
                "decode_graph_capture_s": new_eng["decode_capture_s"],
                "join_s": joined - new_eng["t0"] - new_eng["build_s"]
                - new_eng["warm_s"],
                "fleet_scale_span_ms": out_span[0]["dur"] / 1e3},
            "scale_in": {
                "states": states, "worker_drain_span": a,
                "migrated_chains": len(moved), "migrated_pages": pages,
                "migrated_mb": pages * kv_bytes / 2**20,
                "drain_ms": drain[0]["dur"] / 1e3,
                "import_ms": sum(r["dur"] for r in imports) / 1e3,
                "fleet_series_deltas": fl, "controller_events": acts},
            "prefix_hit": {
                "prompt_tokens": FLEET_P_LEN,
                "tokens_reused": hot["cached_tokens"],
                "ttft_ms_survivor_hit": hot["ttft_ms"],
                "ttft_ms_cold": cold["ttft_ms"],
                "ttft_ms_victim_again": again["ttft_ms"],
                "ids_equal_cold": hot["ids"] == cold["ids"]},
            "peak_mem_gb_two_engines": peak2 / 1e9,
            "segments": seg,
            "autoscaler": {k: status[k] for k in (
                "scale_outs", "scale_ins", "ticks", "drains_lost")}})

        # E: the shipped provider (no warm-up) under the controller's own
        # thread, the new engine's watchdog armed from its first pass
        provider2 = LocalWorkerProvider(model, server_kwargs=engine_kw)
        conf.set("bigdl.observability.federation.interval", "0.1")
        try:
            router2 = LLMRouter([], [seed], failover=True, federation=True,
                                fleet=True, provider=provider2,
                                fleet_opts=FLEET_OPTS).start()
        finally:
            conf.unset("bigdl.observability.federation.interval")
        fc2, rb = router2._fleet, router2.address
        s0 = begin()

        def joined2():
            engines.update(provider2.servers())
            return fc2.scale_outs >= 1 and len(engines) == 3
        burst(rb, 16, lambda: _wait(joined2, 90, "(c) shipped scale-out"),
              "(c) shipped provider's burst")
        new2 = list(engines.values())[-1]
        steps2 = new2.steps
        burst(rb, 8, None, "(c) shipped provider, two engines")
        check(new2.steps > steps2, "(c) the shipped provider's engine "
              "served nothing")
        _wait(lambda: fc2.scale_ins >= 1 and not provider2.servers(), 90,
              "(c) shipped scale-in")
        seg["shipped"] = end(s0, "(c) the shipped provider")
        out2 = spans("fleet/scale", s0, direction="out")
        check(router2.decode_workers == [seed] and router2.failovers == 0
              and len(out2) == 1 and fc2.drains_lost == 0,
              f"(c) shipped provider: pool {router2.decode_workers}, "
              f"failovers {router2.failovers}, spans {out2}")
        out["shipped_provider"] = {
            "requests": 24, "lost": 0, "failovers": router2.failovers,
            "fleet_scale_span_ms": out2[0]["dur"] / 1e3,
            "watchdog_timeout_s": HTTP_WATCHDOG_S,
            "watchdog_trips": new2.watchdog_trips,
            "decode_graph_capture_s": new2._decode.capture_seconds,
            "engine_errors": len(new2.errors),
            "events": [e["action"] for e in fc2.status()["events"]]}
        check(not engines[seed].errors,
              f"(c) engine errors: {engines[seed].errors}")
    finally:
        for r in (router, router2):
            if r is not None:
                r.stop()
        for pv in (provider2, provider):
            if pv is not None:
                pv.stop_all()
        flight.enabled = False
    torch.cuda.empty_cache()
    return out


def _tools_run(torch, model, serve):
    """Phase 13 (d): ``save_model`` / ``load_model`` of phase 3's model,
    ``cli.main``, ``BigdlTpuLLM`` and ``BigdlTpuOpenAI``."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    from bigdl_tpu_torch.llm import cli, convert_model, langchain
    from bigdl_tpu_torch.llm.api import ByteTokenizer
    from bigdl_tpu_torch.llm.models.llama import LlamaForCausalLM
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.llm.worker import LLMWorker

    cfg, new, text = model.config, 32, "Once upon a time"
    out = {"free_disk_gb": shutil.disk_usage(tempfile.gettempdir()).free
           / 1e9}
    check(out["free_disk_gb"] > 10, f"(d) {out['free_disk_gb']:.1f} GB free")
    d = tempfile.mkdtemp()
    try:
        t = time.perf_counter()
        convert_model.save_model(model, d)
        out["save_s"] = time.perf_counter() - t
        out["dir_gb"] = sum(os.path.getsize(os.path.join(d, f))
                            for f in os.listdir(d)) / 1e9
        t = time.perf_counter()
        loaded = convert_model.load_model(d)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t
        # bit for bit against the source as the format keeps it (its q4_0
        # scales rounded to bf16), and beside the unrounded source
        ref = LlamaForCausalLM(cfg, convert_model.as_stored(model.params),
                               device=model.device)
        ids = _phase3_prompts(torch, cfg)[0][None]
        got = loaded.generate(ids, max_new_tokens=new)
        exp = ref.generate(ids, max_new_tokens=new)
        src = model.generate(ids, max_new_tokens=new)
        full = torch.as_tensor(got[:, :-1], device=model.device)
        lg, le, ls = (m(full)[0][0, -1] for m in (loaded, ref, model))
        check((got == exp).all() and torch.equal(lg, le),
              f"(d) the reloaded 7B differs: ids {got.tolist()} against "
              f"{exp.tolist()}, logits max diff "
              f"{(lg - le).abs().max().item()}")
        out["reload"] = {
            "ids_equal": True, "last_logits_bit_equal": True,
            "vs_unrounded_source": {
                "leading_ids_equal": _lead(got[0].tolist(),
                                           src[0].tolist()) - ids.shape[1],
                "last_logits_max_abs_diff": (lg - ls).abs().max().item()}}
        del ref, lg, le, ls
        # the CLI over the directory
        so, se = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = cli.main(["-m", d, "-p", text, "-n", str(new)])
        m = re.fullmatch(r"\[(\d+) tokens in (\d+\.\d\d)s — (\d+\.\d\d) "
                         r"tok/s\]\n", se.getvalue())
        check(rc == 0 and m and int(m.group(1)) == new,
              f"(d) cli {rc} {se.getvalue()!r}")
        cli_text = so.getvalue()[:-1]
        want_ids = loaded.generate(
            [ByteTokenizer().encode(text)], max_new_tokens=new)[0, -new:]
        check(cli_text == ByteTokenizer().decode(want_ids),
              f"(d) cli text {cli_text!r}")
        out["cli"] = {"rc": rc, "tok_per_s": float(m.group(3)),
                      "stderr": se.getvalue().strip()}
        del loaded
        llm = langchain.BigdlTpuLLM(d, max_new_tokens=new)
        check(llm.invoke(text) == cli_text, "(d) BigdlTpuLLM != the CLI")
        srv = LLMServer(llm.model, **SERVE_7B).start()
        w = LLMWorker(srv, api=True, tokenizer=ByteTokenizer()).start()
        try:
            client = langchain.BigdlTpuOpenAI(
                "http://%s:%d/v1" % tuple(w.address), max_tokens=new)
            oa_text = client.invoke(text)
            served = srv.submit(ByteTokenizer().encode(text), new).get(
                timeout=120)
        finally:
            w.stop()
            srv.stop()
        check(oa_text == ByteTokenizer().decode(served)
              or _ascii(oa_text) == _ascii(ByteTokenizer().decode(served)),
              f"(d) BigdlTpuOpenAI {oa_text!r} against the engine's "
              f"{served}")
        out["langchain"] = {
            "llm_equals_cli": True,
            "openai_equals_cli": oa_text == cli_text,
            "engine_ids_leading_equal_to_generate": _lead(
                served, [int(t) for t in want_ids]),
            "openai_text_equals_engine_decode":
                oa_text == ByteTokenizer().decode(served)}
        del llm
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def serve_fleet(torch, model, serve, http):
    """Phase 13 on phase 3's model: (a) and (b) the time-series plane and
    an alert, (c) the elastic fleet, (d) the converter, the CLI and the
    LangChain wrappers."""
    t_phase = time.perf_counter()
    out = {"phase": "fleet", "model": "Llama-2-7B q4_0 (phase 3's model)"}
    t = time.perf_counter()
    out.update(_plane_and_alerts(torch, model, serve, http))
    out["plane_alerts_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["fleet"] = _fleet_run(torch, model, serve)
    out["fleet_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["tools"] = _tools_run(torch, model, serve)
    out["tools_s"] = time.perf_counter() - t
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# -- phase 14: every low-bit format, the native quantizer, the tools ----------

FORMATS = ("sym_int5", "nf4", "fp4", "fp8", "bf16")
# the 7B linears (N, K) at decode batch M = 8
FORMAT_SHAPES = ((12288, 4096, "qkv_proj"), (4096, 4096, "o_proj"),
                 (22016, 4096, "gate_up_proj"), (4096, 11008, "down_proj"))
NATIVE_SHAPE = (4096, 4096)
LOAD_N, LOAD_NEW, LOAD_QPS = 64, 8, 32.0   # run_load: requests, tokens, qps
ROUTED_N = 16                              # fleet_report's routed requests


def _host_cpu():
    """The host CPU as ``/proc/cpuinfo`` names it, and its cores: the
    native quantizer's time depends on them."""
    import platform
    from bigdl_tpu_torch.native.build import host_cpu
    return {"cpuinfo": host_cpu().splitlines()[0], "cores": os.cpu_count(),
            "machine": platform.machine()}


def _bert_formats(torch, dev):
    """BERT-base (phase 5's model and weights) at every new format: nano
    ``quantize`` (sym_int5 / nf4 / fp4 / fp8; its ``"bf16"`` is the float
    cast, so bf16 goes through ``optimize_model``) and ``sym_int4`` beside
    them: ms a forward at batch 8 x 128 (median of 10), launch counts (the
    new formats reach none of the port's kernels), and the card's
    log-probs against the same quantized model's plain forward on the CPU
    (batch 2 x 128), within 2e-2 of their largest magnitude, the same
    argmax on every row."""
    import copy

    import numpy as np
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.transformers import LowBitLinear, optimize_model
    from bigdl_tpu_torch.models.bert import BertConfig, build_classifier
    from bigdl_tpu_torch.nano import InferenceOptimizer
    from bigdl_tpu_torch.nano.inference_optimizer import _CompiledModel
    from bigdl_tpu_torch.nn import set_seed

    cfg = BertConfig.base()
    set_seed(0)
    model = build_classifier(cfg, 2, device=dev)
    ids = torch.randint(0, cfg.vocab_size, (8, 128),
                        generator=torch.Generator().manual_seed(5)).numpy()
    n_linears = 6 * cfg.num_hidden_layers + 2
    rows = {}
    for fmt in ("sym_int4",) + FORMATS:
        t0 = time.perf_counter()
        if fmt == "bf16":
            pipe = _CompiledModel(optimize_model(copy.deepcopy(model),
                                                 "bf16"), dev)
        else:
            pipe = InferenceOptimizer.quantize(model, fmt, device=dev)
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        lows = [m for m in pipe._model.modules()
                if isinstance(m, LowBitLinear)]
        check(len(lows) == n_linears and {m.qtype for m in lows} == {fmt},
              f"BERT {fmt}: {len(lows)} LowBitLinear of "
              f"{ {m.qtype for m in lows} }")
        pipe.forward(ids)                    # warm-up: cuBLAS handles
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        y = pipe.forward(ids)
        counts = kernels.launch_counts()
        check(y.shape == (8, 2) and bool(np.isfinite(y).all()),
              f"BERT {fmt}: output {y.shape} not finite")
        want = dict.fromkeys(counts, 0)
        if fmt == "sym_int4":
            want["int4_matmul"] = n_linears
            want["int4_matmul_tc"] = sum(
                c for _, m, _, n, c in BERT_SHAPES
                if kernels.matmul_route(m, n) == "tc")
            want["int4_matmul_gemv"] = n_linears - want["int4_matmul_tc"]
        check(counts == want, f"BERT {fmt}: launch counts {counts} != "
              f"{want}")
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            pipe.forward(ids)
            walls.append((time.perf_counter() - t0) * 1e3)
        cpu = _CompiledModel(copy.deepcopy(pipe._model), "cpu").forward(
            ids[:2])
        card = pipe.forward(ids[:2])
        err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
        same = bool((card.argmax(1) == cpu.argmax(1)).all())
        check(err <= 2e-2 and same, f"BERT {fmt}: card vs CPU log-probs "
              f"{card.tolist()} vs {cpu.tolist()} (rel err {err})")
        rows[fmt] = {"entry": ("optimize_model" if fmt == "bf16"
                               else "InferenceOptimizer.quantize"),
                     "launches": {k: v for k, v in counts.items() if v},
                     "convert_s": convert_s,
                     "ms_per_forward": statistics.median(walls),
                     "card_vs_cpu_rel_err": err, "same_argmax": same}
        del pipe
    base = rows["sym_int4"]["ms_per_forward"]
    for fmt in FORMATS:
        rows[fmt]["ms_vs_sym_int4"] = [rows[fmt]["ms_per_forward"], base]
    del model
    torch.cuda.empty_cache()
    return {"batch": [8, 128], "linears_per_forward": n_linears,
            "tol": 2e-2, "pipelines": rows}


def _linear_formats(torch, dev):
    """``LowBitLinear`` of every format at the 7B shapes, M = 8, bf16 x:
    the quantize on the card (one call) and the forward (median of 25
    device times), beside the ``sym_int4`` GEMV's. Figures, not gates."""
    import numpy as np
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.ggml.quantize import quantize_torch
    from bigdl_tpu_torch.llm.transformers import LowBitLinear

    gen = torch.Generator(device=dev).manual_seed(14)
    rows = {}
    for n, k, name in FORMAT_SHAPES:
        w = torch.randn((n, k), generator=gen, device=dev) * 0.02
        x = torch.randn((8, k), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        row = {}
        for fmt in ("sym_int4",) + FORMATS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            quantize_torch(w, fmt)
            torch.cuda.synchronize()
            q_ms = (time.perf_counter() - t0) * 1e3
            m = LowBitLinear.from_weight(w, fmt)
            kernels.reset_launch_counts()
            with torch.inference_mode():
                y = m(x)
                ms = time_ms(lambda: m(x))
            check(y.shape == (8, n) and bool(torch.isfinite(y).all()),
                  f"LowBitLinear {fmt} {name}: output not finite")
            launched = kernels.launch_counts()["int4_matmul_gemv"]
            check((launched > 0) == (fmt == "sym_int4"),
                  f"LowBitLinear {fmt} {name}: {launched} GEMV launches")
            nbytes = sum(b.numel() * b.element_size() for b in m.buffers())
            row[fmt] = {"ms": ms, "quantize_ms": q_ms,
                        "weight_mb": nbytes / 2**20,
                        "bound_ms": bound(nbytes + x.numel() * 2
                                          + y.numel() * 2,
                                          2 * 8 * n * k)[0]}
            del m
        rows[f"{name} M=8 K={k} N={n}"] = row
        del w
    torch.cuda.empty_cache()
    return rows


def _native_quantizer(torch, dev):
    """The native quantizer built with ``g++`` on this machine, bit-equal
    to the numpy path on a 4096 x 4096 weight (q4_0 and q8_0; times of
    both); then ``quantize_torch`` on the card at every format of the
    same weight (a few edge values planted: a zero block, e4m3fn's tie
    at 464, an overflow, ±inf for the casts) bit-equal to numpy, and
    ``quantize_model``'s per-channel int8 on the card bit-equal to the
    CPU's."""
    import numpy as np
    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.llm.ggml.quantize import (CAST_QTYPES, ggml_qtypes,
                                                   quantize, quantize_numpy,
                                                   quantize_torch)
    from bigdl_tpu_torch.native import build as native_build
    from bigdl_tpu_torch.nn.quantized import _quantize_per_channel

    t0 = time.perf_counter()
    check(native.available(), "the native quantizer did not build with "
          "g++ on this machine")
    out = {"host_cpu": _host_cpu(),
           "library": os.path.basename(native_build.lib_path()),
           "build_s": native_build.build_seconds,
           "first_use_s": time.perf_counter() - t0, "shape": NATIVE_SHAPE}
    w = (np.random.RandomState(14).randn(*NATIVE_SHAPE) * 0.02).astype(
        np.float32)
    w[0, :32] = 0.0
    w[1, :4] = [464.0, -464.0, 480.0, 1e5]
    errs = np.seterr(over="ignore")    # the planted overflow's fp16 scale
    for qtype in ("sym_int4", "sym_int8"):
        t = time.perf_counter()
        nat = quantize(w, qtype)
        nat_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        ref = quantize_numpy(w, qtype)
        np_ms = (time.perf_counter() - t) * 1e3
        check(all(np.array_equal(nat[k], ref[k]) for k in ("q", "scale")),
              f"native {qtype} differs from the numpy path")
        out[qtype] = {"native_ms": nat_ms, "numpy_ms": np_ms,
                      "bit_equal": True}
    wd = torch.from_numpy(w).to(dev)
    for qtype in ggml_qtypes():
        wq = w.copy()
        if qtype in CAST_QTYPES:
            wq[2, :2] = [np.inf, -np.inf]
        wd.copy_(torch.from_numpy(wq))
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = quantize_torch(wd, qtype)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        ref = quantize_numpy(wq, qtype)
        np_ms = (time.perf_counter() - t) * 1e3
        for k, v in ref.items():
            if k == "qtype":
                continue
            g = got[k].cpu()
            if g.dtype in (torch.bfloat16, torch.float8_e4m3fn):
                g = g.view(torch.int16 if g.element_size() == 2
                           else torch.uint8)
            g = g.numpy()
            check(np.array_equal(g.view(v.dtype), v),
                  f"quantize_torch {qtype} on the card: {k} differs from "
                  "numpy")
        out[f"quantize_torch {qtype}"] = {"card_ms": card_ms,
                                          "numpy_ms": np_ms,
                                          "bit_equal": True}
    np.seterr(**errs)
    wd.copy_(torch.from_numpy(w))
    card = _quantize_per_channel(wd)
    cpu = _quantize_per_channel(torch.from_numpy(w))
    check(all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)),
          "quantize_model's per-channel int8 on the card differs from the "
          "CPU's")
    out["quantize_model per-channel int8"] = {"bit_equal": True}
    return out


def formats_phase(torch, dev):
    """Phase 14 (a): every low-bit format on the card."""
    t = time.perf_counter()
    out = {"phase": "formats", "formats": FORMATS}
    out["bert"] = _bert_formats(torch, dev)
    out["linears"] = _linear_formats(torch, dev)
    out["native"] = _native_quantizer(torch, dev)
    out["wall_s"] = time.perf_counter() - t
    return out


def _load_run(torch, model, srvs, addr, prompts, want, what, **kw):
    """``run_load`` of ``prompts`` against ``addr`` (engines ``srvs``):
    no request lost, each index ``want``'s, and the launch counts (zeroed
    just before) exactly each prompt's whole prefill and the engines'
    decode steps."""
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.tools import loadgen

    steps0 = sum(s.steps for s in srvs)
    kernels.reset_launch_counts()
    res = loadgen.run_load(addr, prompts, max_new_tokens=LOAD_NEW,
                           qps=LOAD_QPS, concurrency=8, **kw)
    counts = kernels.launch_counts()
    steps = sum(s.steps for s in srvs) - steps0
    check(res["lost"] == 0 and res["ok"] == len(prompts),
          f"{what}: lost {res['lost']}: {res['errors']}")
    check(res["outputs"] == want, f"{what}: outputs differ from the "
          f"engine's answers alone: {res['outputs']} vs {want}")
    expect = _path_expect(model, [_bucket(len(p), model.page_size)
                                  for p in prompts], steps)
    check(counts == expect, f"{what}: launch counts {counts} != {expect}")
    res.pop("outputs")
    return {**res, "decode_steps": steps, "launches": counts}


def tools_phase(torch, model):
    """Phase 14 (b) on phase 3's model: the load generator, the fleet
    soak, ``fleet_report --url`` and the alerts and fleet chaos drives."""
    import contextlib
    import io

    from bigdl_tpu_torch.llm import chaos
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.llm.worker import LLMRouter, LLMWorker
    from bigdl_tpu_torch.tools import fleet_report, loadgen

    t_phase = time.perf_counter()
    out = {"phase": "tools", "model": "Llama-2-7B q4_0 (phase 3's model)",
           "engine": dict(SERVE_7B, max_queue=16)}
    prompts = loadgen.gen_prompts(LOAD_N, seed=0, shared_prefix=16)
    srv = LLMServer(model, max_queue=16, **SERVE_7B)
    _warm_inline(torch, srv, prompts[:len(loadgen.PROMPT_LENS)],
                 "phase 14 (b)")
    srv.start()
    w = LLMWorker(srv, api=True).start()
    try:
        # the reference: each prompt alone on this engine
        want = [list(map(int, srv.submit(p, LOAD_NEW).get(timeout=600)))
                for p in prompts]
        out["load"] = {
            name: _load_run(torch, model, [srv], w.address, prompts, want,
                            f"run_load {name}", **kw)
            for name, kw in (("native", {}),
                             ("openai streamed", dict(openai=True,
                                                      stream=True)))}
    finally:
        w.stop()
        srv.stop()
    check(not srv.errors, f"phase 14 (b) engine errors: {srv.errors}")
    out["load"]["requests"] = LOAD_N
    out["load"]["qps"] = LOAD_QPS
    out["load"]["max_new_tokens"] = LOAD_NEW

    # fleet_report --url against a federated router over two engines
    srvs = [LLMServer(model, slo=True, **SERVE_7B) for _ in range(2)]
    for s in srvs:
        _warm_inline(torch, s, prompts[:len(loadgen.PROMPT_LENS)],
                     "phase 14 (b) fleet")
        s.start()
    workers = [LLMWorker(s, role="decode", federation=True).start()
               for s in srvs]
    router = LLMRouter([], [x.address for x in workers], failover=True,
                       federation=True, slo=True,
                       start_prober=False).start()
    try:
        routed = _load_run(torch, model, srvs, router.address,
                           prompts[:ROUTED_N], want[:ROUTED_N],
                           "run_load through the federated router")
        router._collector.collect_now()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fleet_report.main(["--url", "%s:%d" % router.address,
                                    "--json"])
        rep = json.loads(buf.getvalue())
    finally:
        router.stop()
        for x in workers:
            x.stop()
        for s in srvs:
            s.stop()
    check(rc == 0 and len(rep["instances"]) >= 2,
          f"fleet_report --url: rc {rc}, instances {rep.get('instances')}")
    bad = [r for r in rep["counters"] if r["sum"] != r["federated"]]
    check(not bad, f"fleet_report --url: merged counters differ from the "
          f"members' sums: {bad}")
    tokens = next(r for r in rep["counters"]
                  if r["name"] == "bigdl_llm_decode_tokens_total")
    check(tokens["federated"] > 0, f"fleet_report: {tokens}")
    out["fleet_report"] = {"routed": routed,
                           "instances": rep["instances"],
                           "counters": len(rep["counters"]),
                           "sketches": len(rep["sketches"]),
                           "decode_tokens_federated": tokens["federated"]}

    t = time.perf_counter()
    soak = loadgen.run_fleet_soak(model=model)
    check(soak["requests_lost"] == 0 and soak["scale_outs"] >= 1
          and soak["scale_ins"] >= 1 and soak["converged_workers"] == 1,
          f"run_fleet_soak at 7B: {soak}")
    out["fleet_soak"] = {**soak, "wall_s": time.perf_counter() - t}
    t = time.perf_counter()
    alerts = chaos.run_alerts_chaos(model=model, smoke=True)
    out["alerts_chaos"] = {**alerts, "wall_s": time.perf_counter() - t}
    t = time.perf_counter()
    fleet = chaos.run_fleet_chaos(model=model, smoke=True)
    check(fleet["reference"] == "engine", f"fleet chaos: {fleet}")
    out["fleet_chaos"] = {**fleet, "wall_s": time.perf_counter() - t}
    out["wall_s"] = time.perf_counter() - t_phase
    return out



# -- phase 15: DLlib training — LeNet-5 and ResNet-50 ----------------------------

def _device_window(torch, prof, steps):
    """A profiler window of ``steps`` train steps: the device's busy time
    (the union of its kernel and copy intervals, so a side-stream copy
    under a kernel counts once), the span from the first device event to
    the last, kernels and copies a step, the top kernels."""
    cuda_t = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.events() if e.device_type == cuda_t]
    check(evs, "phase 15 profile: no device events (CUPTI gave nothing)")
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0, b - max(a, end))
        end = max(end, b)
    window = spans[-1][1] - spans[0][0]
    copies = [e for e in evs if e.name.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for e in evs:
        if e in copies:
            continue
        n = e.name if len(e.name) < 60 else e.name[:57] + "..."
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / window,
            "device_idle_share": 1 - busy / window,
            "kernel_launches_per_step": (len(evs) - len(copies)) / steps,
            "copies_per_step": len(copies) / steps,
            "top_kernels_ms_per_step": {n: [t / steps, c / steps]
                                        for n, (t, c) in top}}


def _lenet_run(dev, data, val, tmp, name, epochs, model=None):
    """The JAX package's LeNet-5 recipe through ``LocalOptimizer``, its
    checkpoints under ``tmp/name``: (optimizer, top-1 by validation)."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models import lenet
    if model is None:
        nn.set_seed(0)
        model = lenet.build_model(10, device=dev)
    opt = optim.LocalOptimizer(model, data, nn.ClassNLLCriterion(),
                               batch_size=128,
                               end_trigger=optim.Trigger.max_epoch(epochs),
                               device=dev)
    opt.set_optim_method(optim.Adam(learning_rate=0.003))
    opt.set_validation(optim.Trigger.every_epoch(), val,
                       [optim.Top1Accuracy()], batch_size=128)
    opt.set_checkpoint(os.path.join(tmp, name), optim.Trigger.every_epoch())
    summary = optim.ValidationSummary(os.path.join(tmp, "logs"), name)
    opt.set_val_summary(summary)
    opt.optimize()
    scores = [v for _, v in summary.read_scalar("Top1Accuracy")]
    summary.close()
    return opt, scores


def lenet_phase(torch, dev, tmp):
    """(a) LeNet-5 on ``load_mnist()``'s synthetic digits through the
    port's ``LocalOptimizer`` (the JAX package's recipe: Adam 0.003,
    batch 128, 6 epochs, Top1 validation and a checkpoint every epoch);
    top-1 on the test split above 0.9; then a run stopped after epoch 3,
    a fresh model and optimizer auto-resuming from its checkpoint
    directory (the dataset object carries on, so the batches are the
    uninterrupted run's), ending within 1e-3 of each weight tensor's
    largest magnitude of the uninterrupted run's weights: cuDNN's
    backward and the max-pool backward sum with atomics, so the two runs
    differ in the last bits, not bit for bit."""
    from bigdl_tpu_torch import nn, optim, reliability
    from bigdl_tpu_torch.feature.dataset import LocalDataSet
    from bigdl_tpu_torch.feature.mnist import load_mnist, normalize
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.utils.tree import tree_leaves
    check(reliability.enabled(), "phase 15 (a): the auto-resume needs "
          "bigdl.reliability.enabled")
    x, y = load_mnist(synthetic_size=1024)
    x = normalize(x)
    xv, yv = load_mnist(synthetic_size=256, train=False)
    val = (normalize(xv), yv)
    t = time.perf_counter()
    opt, scores = _lenet_run(dev, LocalDataSet(x, y, seed=0), val, tmp,
                             "full", 6)
    full = opt.model
    full_s = time.perf_counter() - t
    top1 = optim.Evaluator(full, device=dev).evaluate(
        val, [optim.Top1Accuracy()], batch_size=128)[0].result
    check(top1 > 0.9, f"phase 15 (a): LeNet-5 top-1 {top1} <= 0.9")
    check(len(scores) == 6, f"phase 15 (a): validations {scores}")
    ds = LocalDataSet(x, y, seed=0)
    _lenet_run(dev, ds, val, tmp, "cut", 3)
    nn.set_seed(1)
    fresh = lenet.build_model(10, device=dev)
    opt, rscores = _lenet_run(dev, ds, val, tmp, "cut", 6, model=fresh)
    resumed = opt.model
    # one log: the cut run validated epochs 1-3, the resumed run 4-6
    check(resumed is fresh and opt.state["epoch"] == 7
          and len(rscores) == 6,
          f"phase 15 (a): the resumed run: {opt.state}, {rscores}")
    diffs = []
    for a, b in zip(tree_leaves(resumed.parameters_dict()),
                    tree_leaves(full.parameters_dict())):
        a, b = a.detach(), b.detach()
        d = float((a - b).abs().max())
        diffs.append(d)
        check(d <= 1e-3 * max(1.0, float(b.abs().max())),
              f"phase 15 (a): resumed weights differ by {d}")
    return {"what": "LeNet-5, synthetic MNIST 1024 / 256, Adam 0.003, "
                    "batch 128, 6 epochs",
            "top1": top1, "val_top1_by_epoch": scores,
            "final_loss": opt.state["loss"], "train_s": full_s,
            "steps": 6 * (1024 // 128),
            "resume_max_abs_diff_by_tensor": diffs,
            "resume_tolerance": "1e-3 x max(1, max|w|) per tensor"}


def _resnet_batches(n, batch):
    """``n`` batches of bf16-bound images (NHWC, U[0, 1), made as f32 on
    the host: numpy has no bf16) and 1-based labels, from seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    x = rng.random((n * batch, 224, 224, 3), dtype=np.float32)
    y = (rng.integers(0, 1000, n * batch) + 1).astype(np.int32)
    return x, y


def resnet_phase(torch, dev):
    """(b) ResNet-50 at ImageNet width (``resnet_imagenet(50, 1000,
    format="NHWC")``, 224 x 224, batch 256, bf16 inputs cast on the card
    by ``set_input_dtype``, f32 weights and update, 1-based labels) under
    SGD 0.1 with momentum 0.9 and weight decay 1e-4 through the port's
    ``LocalOptimizer``: 3 warm-up steps, then 20 timed by CUDA events
    recorded as each step is dispatched (ms a step: their mean, and the
    median beside it; images/s from the mean), peak
    memory, and a ``torch.profiler`` window of 3 more steps (device busy
    and idle share, launches a step). No kernel of the port's runs on
    this path (its conv, pool and BN are ATen / cuDNN ops): the port's
    launch counters stay 0."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.models import resnet
    from torch.profiler import ProfilerActivity, profile as trace
    batch, warm, timed, prof_steps = 256, 3, 20, 3
    t = time.perf_counter()
    x, y = _resnet_batches(warm + timed + prof_steps + 1, batch)
    data_s = time.perf_counter() - t
    nn.set_seed(0)
    model = resnet.resnet_imagenet(50, 1000, format="NHWC", device=dev)
    opt = optim.LocalOptimizer(model, (x, y), nn.ClassNLLCriterion(),
                               batch, optim.Trigger.max_iteration(
                                   warm + timed + prof_steps), device=dev)
    opt.set_optim_method(optim.SGD(0.1, momentum=0.9, weight_decay=1e-4))
    opt.set_input_dtype(torch.bfloat16)
    marks, window = [], {}
    step = opt._train_step

    def timed_step(*a):
        i = len(marks)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()            # before the profiler's start-up, which
        marks.append(ev)       # holds the host for seconds
        if i == warm + timed:
            torch.cuda.synchronize()
            window["prof"] = trace(activities=[ProfilerActivity.CUDA])
            window["prof"].start()
        out = step(*a)
        if i == warm + timed + prof_steps - 1:
            torch.cuda.synchronize()
            window["prof"].stop()
        return out

    opt._train_step = timed_step
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    opt.optimize()
    wall = time.perf_counter() - t
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    check(not counts, f"phase 15 (b): port kernels launched: {counts}")
    ms = [marks[i].elapsed_time(marks[i + 1])
          for i in range(warm, warm + timed)]
    step_ms = sum(ms) / len(ms)
    loss = opt.state["loss"]
    check(math.isfinite(loss), f"phase 15 (b): loss {loss}")
    prof = _device_window(torch, window["prof"], prof_steps)
    return {"what": "ResNet-50 NHWC 224x224 batch 256, bf16 inputs, SGD "
                    "0.1 m 0.9 wd 1e-4, LocalOptimizer",
            "step_ms": step_ms, "step_ms_each": ms,
            "step_ms_median": statistics.median(ms),
            "images_per_s": batch / step_ms * 1e3,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "final_loss": loss, "optimize_wall_s": wall,
            "data_gen_s": data_s,
            "host_step_s_mean": opt.metrics.mean("compute"),
            "host_data_wait_s_mean": opt.metrics.mean("data"),
            "port_kernel_launches": counts, "profile": prof}


def _resnet_step(torch, init, x, y, device, fmt="NHWC"):
    """One ``LocalOptimizer`` SGD step of ResNet-50 from ``init`` on
    ``device``: (the model after it, its loss, seconds)."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models import resnet
    m = resnet.resnet_imagenet(50, 1000, format=fmt, device="cpu")
    m.load_state_dict(init)
    opt = optim.LocalOptimizer(m, (x, y), nn.ClassNLLCriterion(), 2,
                               optim.Trigger.max_iteration(1), device=device)
    opt.set_optim_method(optim.SGD(0.1, momentum=0.9, weight_decay=1e-4))
    t = time.perf_counter()
    out = opt.optimize()
    return out, opt.state["loss"], time.perf_counter() - t


def resnet_card_vs_cpu(torch, dev):
    """(c) The same full-width ResNet-50 (NHWC, f32, batch 2 at 224,
    TF32 off) one ``LocalOptimizer`` SGD step on the card and on the CPU
    from the same weights. The loss within 1e-5 (relative) and every BN
    running statistic within 1e-4 + 1e-4 x |value|: both come from the
    forward. The step's gradient is ill-conditioned in f32 at batch 2 (a
    ReLU input that rounds across 0 moves whole BN channels): the CPU
    against itself at 1 and at all threads already moves single update
    tensors by 10-25% of their largest entry. So every parameter tensor
    is held to its own update (|w_card - w_cpu| <= max |w_cpu - w_0|),
    the whole update's L2 deviation to max(0.1, 3 x the CPU's own across
    thread counts), and both deviations are reported. The NCHW model on
    the same weights gives the NHWC loss within 1e-5 on the card."""
    import numpy as np

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import resnet
    from bigdl_tpu_torch.utils.tree import tree_leaves
    rng = np.random.default_rng(1)
    x = rng.random((2, 224, 224, 3), dtype=np.float32)
    y = np.array([17.0, 905.0], np.float32)
    nn.set_seed(0)
    init = {k: v.detach().clone() for k, v in resnet.resnet_imagenet(
        50, 1000, format="NHWC", device="cpu").state_dict().items()}
    cpu_m, cpu_l, cpu_s = _resnet_step(torch, init, x, y, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one_m, one_l, one_s = _resnet_step(torch, init, x, y, "cpu")
    finally:
        torch.set_num_threads(threads)
    card_m, card_l, card_s = _resnet_step(torch, init, x, y, dev)
    check(abs(card_l - cpu_l) <= 1e-5 * abs(cpu_l),
          f"phase 15 (c): loss {card_l} vs {cpu_l}")
    stats = 0.0
    for a, b in zip(tree_leaves(card_m.states_dict()),
                    tree_leaves(cpu_m.states_dict())):
        a = a.cpu()
        check(bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all()),
              f"phase 15 (c): BN statistics differ by "
              f"{float((a - b).abs().max())}")
        stats = max(stats, float((a - b).abs().max()))
    w0 = [init[k] for k, _ in cpu_m.named_parameters()]
    per, sq = {"card": [], "cpu_1_thread": []}, {"card": 0.0,
                                                  "cpu_1_thread": 0.0}
    upd_sq = 0.0
    for (name, w), w_0, c, o in zip(cpu_m.named_parameters(), w0,
                                    card_m.parameters(), one_m.parameters()):
        w, c, o = w.detach(), c.detach().cpu(), o.detach()
        upd = float((w - w_0).abs().max())
        upd_sq += float(((w - w_0) ** 2).sum())
        for key, other in (("card", c), ("cpu_1_thread", o)):
            d = float((other - w).abs().max())
            per[key].append(d / upd if upd else 0.0)
            sq[key] += float(((other - w) ** 2).sum())
            if key == "card":
                check(d <= upd + 1e-7, f"phase 15 (c): {name} moved "
                      f"{d} from the CPU's, its update is {upd}")
    l2 = {k: math.sqrt(v / upd_sq) for k, v in sq.items()}
    check(l2["card"] <= max(0.1, 3 * l2["cpu_1_thread"]),
          f"phase 15 (c): the card's update deviates by {l2}")
    nchw = resnet.resnet_imagenet(50, 1000, device="cpu")
    nchw.load_state_dict(init)
    nhwc = resnet.resnet_imagenet(50, 1000, format="NHWC", device="cpu")
    nhwc.load_state_dict(init)
    crit = nn.ClassNLLCriterion()
    xt = torch.from_numpy(x).to(dev)
    yt = torch.from_numpy(y).to(dev)
    with torch.no_grad():
        l_nhwc = float(crit.apply_loss(nhwc.to(dev).train()(xt), yt))
        l_nchw = float(crit.apply_loss(
            nchw.to(dev).train()(xt.permute(0, 3, 1, 2).contiguous()), yt))
    check(abs(l_nhwc - l_nchw) <= 1e-5 * abs(l_nhwc),
          f"phase 15 (c): NHWC loss {l_nhwc} vs NCHW {l_nchw}")
    return {"loss_card_cpu_cpu1": [card_l, cpu_l, one_l],
            "bn_stats_max_abs_diff": stats,
            "update_dev_max_over_tensors": {k: max(v)
                                            for k, v in per.items()},
            "update_dev_l2": l2,
            "loss_nhwc_nchw": [l_nhwc, l_nchw],
            "step_s_card_cpu_cpu1": [card_s, cpu_s, one_s],
            "tolerance": "loss 1e-5 rel; BN stats 1e-4 + 1e-4 |x|; each "
                         "parameter within its own update's max; the "
                         "update's L2 deviation <= max(0.1, 3 x CPU 1 vs "
                         "all threads); NHWC vs NCHW 1e-5 rel; TF32 off"}


def dllib_phase(torch, dev):
    """Phase 15: (a) LeNet-5, (b) ResNet-50 timed and profiled, (c)
    ResNet-50 card against CPU."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        lenet = lenet_phase(torch, dev, tmp)
    torch.cuda.empty_cache()
    train = resnet_phase(torch, dev)
    torch.cuda.empty_cache()
    parity = resnet_card_vs_cpu(torch, dev)
    return {"phase": "dllib", "lenet": lenet, "resnet50": train,
            "card_vs_cpu": parity, "wall_s": time.perf_counter() - t0}


# -- phase 16: the DLlib graph and Keras API: Inception-v1, a Keras GoogLeNet
# and a PTB LSTM ------------------------------------------------------------------

# the reference's Inception-v1 recipe (models/inception: SGD, learning rate
# 0.0898, momentum 0.9, weight decay 1e-4); Zaremba et al. 2014 (arXiv
# 1409.2329) section 4.1, "medium": 2 x 650 LSTM, 35 steps, batch 20,
# vocabulary 10,000, SGD 1.0 with the gradient's norm clipped at 5
INCEPTION_SGD = dict(learning_rate=0.0898, momentum=0.9, weight_decay=1e-4)
PTB_MEDIUM = dict(vocab=10000, hidden=650, layers=2, steps=35, batch=20)
# the card-vs-CPU limits of (a) and (c) (see ``_card_vs_cpu``), set from
# an H100 run's readings (Inception-v1 224 x 224 / the PTB LSTM, batch 2):
# the centred eval log-probabilities' deviation over their spread (read
# 6.6e-5 / 1.5e-5; two f32 ulps at -6.9 are 6.6e-5 of Inception's spread
# 0.0144), and each parameter tensor's deviation over its own update's
# largest entry (read 4.5e-3 / 1.5e-3; the CPU's own at 1 against 8
# threads 2.6e-3 / 0)
LP_TOL = 5e-4
PER_TENSOR_TOL = 0.05


def _no_port_launches(kernels, what):
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    check(not counts, f"{what}: port kernels launched: {counts}")
    return counts


def _timed_optimize(torch, opt, warm, timed, prof_steps):
    """``opt.optimize()`` with its train step wrapped as phase 15 (b)
    does: a CUDA event recorded as each step is dispatched (``warm``
    steps, then ``timed``), then a ``torch.profiler`` window over
    ``prof_steps`` more. Returns (ms of each timed step, the window's
    device summary, the optimize wall s)."""
    from torch.profiler import ProfilerActivity, profile as trace
    marks, window = [], {}
    step = opt._train_step

    def timed_step(*a):
        i = len(marks)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        if i == warm + timed:
            torch.cuda.synchronize()
            window["prof"] = trace(activities=[ProfilerActivity.CUDA])
            window["prof"].start()
        out = step(*a)
        if i == warm + timed + prof_steps - 1:
            torch.cuda.synchronize()
            window["prof"].stop()
        return out

    opt._train_step = timed_step
    t = time.perf_counter()
    opt.optimize()
    wall = time.perf_counter() - t
    ms = [marks[i].elapsed_time(marks[i + 1])
          for i in range(warm, warm + timed)]
    return ms, _device_window(torch, window["prof"], prof_steps), wall


def _update_deviation(init, ref, others, names):
    """Each model of ``others`` beside ``ref`` after one step from
    ``init``: the largest deviation of a parameter tensor over its own
    update's largest entry, and the whole update's L2 deviation."""
    per = {k: [] for k in others}
    sq = {k: 0.0 for k in others}
    upd_sq = 0.0
    for name in names:
        w = ref[name].detach().cpu()
        w0 = init[name]
        upd = float((w - w0).abs().max())
        upd_sq += float(((w - w0) ** 2).sum())
        for k, m in others.items():
            o = m[name].detach().cpu()
            per[k].append(float((o - w).abs().max()) / upd if upd else 0.0)
            sq[k] += float(((o - w) ** 2).sum())
    return ({k: max(v) for k, v in per.items()},
            {k: math.sqrt(v / upd_sq) for k, v in sq.items()})


def _one_step(torch, build, init, x, y, crit, method, device, clip=None):
    """One ``LocalOptimizer`` step of ``build()`` from ``init`` on
    ``device`` (dropout drawn from one seeded CPU generator, so the card
    and the CPU drop the same units): (its parameters, loss, s)."""
    from bigdl_tpu_torch import optim
    m = build()
    m.load_state_dict(init)
    for mod in m.modules():
        if hasattr(mod, "_draw_generator"):
            mod.generator = torch.Generator().manual_seed(0)
    opt = optim.LocalOptimizer(m, (x, y), crit, len(x),
                               optim.Trigger.max_iteration(1), device=device)
    opt.set_optim_method(method())
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    t = time.perf_counter()
    out = opt.optimize()
    return dict(out.named_parameters()), opt.state["loss"], \
        time.perf_counter() - t


def _card_vs_cpu(torch, dev, build, x, y, crit, method, what, l2_floor,
                 clip=None):
    """One f32 step (TF32 off) on the card and on the CPU at all threads
    and at one, from one set of weights: the loss within 1e-5 (relative);
    the eval-mode log-probabilities of the weights before the step, each
    row less its own mean (at init they lie near -log(classes), and what
    the model says is their spread about that), within ``LP_TOL`` of that
    spread's largest entry; each parameter tensor within ``PER_TENSOR_TOL``
    of its own update's largest entry; and the update's L2 deviation
    within max(``l2_floor``, 3 x the CPU's own between its thread
    counts)."""
    init = {k: v.detach().clone()
            for k, v in build().state_dict().items()}
    m_cpu, m_dev = build(), build()
    m_cpu.load_state_dict(init)
    m_dev.load_state_dict(init)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        lp_cpu = m_cpu.eval()(xt)
        lp_dev = m_dev.to(dev).eval()(xt.to(dev)).cpu()
    c_cpu = lp_cpu - lp_cpu.mean(-1, keepdim=True)
    c_dev = lp_dev - lp_dev.mean(-1, keepdim=True)
    spread = float(c_cpu.abs().max())
    lp_err = float((c_dev - c_cpu).abs().max()) / spread
    check(lp_err <= LP_TOL, f"{what}: log-probabilities about their mean "
                            f"differ by {lp_err} of their spread {spread}")
    del m_dev
    cpu, cpu_l, cpu_s = _one_step(torch, build, init, x, y, crit, method,
                                  "cpu", clip)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one, one_l, one_s = _one_step(torch, build, init, x, y, crit, method,
                                      "cpu", clip)
    finally:
        torch.set_num_threads(threads)
    card, card_l, card_s = _one_step(torch, build, init, x, y, crit, method,
                                     dev, clip)
    check(abs(card_l - cpu_l) <= 1e-5 * abs(cpu_l),
          f"{what}: loss {card_l} vs {cpu_l}")
    names = [k for k in cpu]
    per, l2 = _update_deviation(init, cpu, {"card": card,
                                            "cpu_1_thread": one}, names)
    check(per["card"] <= PER_TENSOR_TOL,
          f"{what}: a parameter deviates by more than {PER_TENSOR_TOL} of "
          f"its update: {per}")
    check(l2["card"] <= max(l2_floor, 3 * l2["cpu_1_thread"]),
          f"{what}: the update deviates by {l2}")
    return {"loss_card_cpu_cpu1": [card_l, cpu_l, one_l],
            "log_prob_dev_over_spread": lp_err,
            "log_prob_spread": spread,
            "log_prob_max_abs_err": float((lp_dev - lp_cpu).abs().max()),
            "update_dev_max_over_tensors": per, "update_dev_l2": l2,
            "step_s_card_cpu_cpu1": [card_s, cpu_s, one_s],
            "cpu_threads": threads,
            "tolerance": f"loss 1e-5 rel; eval log-probs less their row "
                         f"mean within {LP_TOL} of their spread; each "
                         f"parameter within {PER_TENSOR_TOL} of its own "
                         f"update's max; the update's L2 deviation <= max("
                         f"{l2_floor}, 3 x CPU 1 vs all threads); TF32 "
                         f"off"}


def inception_phase(torch, dev):
    """(a) Inception-v1 at full width (``inception_v1(1000)``, 224 x 224,
    batch 256, bf16 inputs by ``set_input_dtype``, f32 weights, 1-based
    labels) under the reference's SGD recipe through ``LocalOptimizer``:
    3 warm-up and 20 timed steps, a 3-step profiler window, peak memory;
    then 4 steps fed by the port's own pipeline: the images of
    ``synthetic_imagenet_dataset(image_size=256)`` drawn before the window
    (their draw timed alone: it stands in for a decode, and is no part of
    the pipeline), then ``RandomCrop(224, 224)`` → ``HFlip`` → the
    prefetcher, whose host data wait a step is reported beside the
    compute (host-bound; not checked); then one f32 step at batch 2 on
    the card and on the CPU."""
    import numpy as np

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.feature.dataset import DataSet
    from bigdl_tpu_torch.feature.imagenet import synthetic_imagenet_dataset
    from bigdl_tpu_torch.feature.transformers import HFlip, RandomCrop
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.models import inception
    batch, warm, timed, prof_steps, fed = 256, 3, 20, 3, 4
    t = time.perf_counter()
    rng = np.random.default_rng(0)
    n = (warm + timed + prof_steps + 1) * batch
    x = rng.random((n, 3, 224, 224), dtype=np.float32)
    y = (rng.integers(0, 1000, n) + 1).astype(np.int32)
    data_s = time.perf_counter() - t
    nn.set_seed(0)
    model = inception.inception_v1(1000, device=dev)
    opt = optim.LocalOptimizer(model, (x, y), nn.ClassNLLCriterion(), batch,
                               optim.Trigger.max_iteration(
                                   warm + timed + prof_steps), device=dev)
    opt.set_optim_method(optim.SGD(**INCEPTION_SGD))
    opt.set_input_dtype(torch.bfloat16)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    ms, prof, wall = _timed_optimize(torch, opt, warm, timed, prof_steps)
    counts = _no_port_launches(kernels, "phase 16 (a)")
    del x, y
    loss = opt.state["loss"]
    check(math.isfinite(loss), f"phase 16 (a): loss {loss}")
    step_ms = sum(ms) / len(ms)
    train = {"what": "Inception-v1 (GoogLeNet trunk, 2 LRN) 224x224 batch "
                     "256 NCHW, bf16 inputs, SGD 0.0898 m 0.9 wd 1e-4, "
                     "LocalOptimizer",
             "step_ms": step_ms, "step_ms_each": ms,
             "step_ms_median": statistics.median(ms),
             "images_per_s": batch / step_ms * 1e3,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
             "final_loss": loss, "optimize_wall_s": wall,
             "data_gen_s": data_s,
             "host_step_s_mean": opt.metrics.mean("compute"),
             "port_kernel_launches": counts, "profile": prof}
    t = time.perf_counter()
    drawn = list(synthetic_imagenet_dataset(n=fed * batch, classes=1000,
                                            image_size=256, seed=0).data())
    draw_s = time.perf_counter() - t
    ds = DataSet.array(drawn, shuffle=False).transform(
        RandomCrop(224, 224, seed=0) >> HFlip(seed=1))
    fopt = optim.LocalOptimizer(model, ds, nn.ClassNLLCriterion(), batch,
                                optim.Trigger.max_iteration(fed), device=dev)
    fopt.set_optim_method(optim.SGD(**INCEPTION_SGD))
    fopt.set_input_dtype(torch.bfloat16)
    kernels.reset_launch_counts()
    t = time.perf_counter()
    fopt.optimize()
    fed_wall = time.perf_counter() - t
    _no_port_launches(kernels, "phase 16 (a) pipeline-fed")
    check(math.isfinite(fopt.state["loss"]),
          f"phase 16 (a) pipeline-fed: loss {fopt.state['loss']}")
    del drawn
    pipe = {"what": "synthetic_imagenet_dataset(image_size=256)'s images "
                    "drawn before the window, then RandomCrop(224, 224) -> "
                    "HFlip -> collate -> the prefetcher (depth 2), batch "
                    "256, 4 steps",
            "draw_s_per_step": draw_s / fed,
            "host_data_wait_s_mean": fopt.metrics.mean("data"),
            "host_compute_s_mean": fopt.metrics.mean("compute"),
            "wall_s": fed_wall, "steps": fed,
            "images_per_s_fed": fed * batch / fed_wall}
    del model, opt, fopt
    torch.cuda.empty_cache()
    xs = np.random.default_rng(1).random((2, 3, 224, 224), dtype=np.float32)
    ys = np.array([17.0, 905.0], np.float32)
    nn.set_seed(0)
    parity = _card_vs_cpu(
        torch, dev, lambda: inception.inception_v1(1000, device="cpu"), xs,
        ys, nn.ClassNLLCriterion(), lambda: optim.SGD(**INCEPTION_SGD),
        "phase 16 (a) card vs CPU", 1e-3)  # read 2.5e-4 (CPU: 2.8e-4)
    return {"train": train, "pipeline_fed": pipe, "card_vs_cpu": parity}


def _keras_googlenet(K, size=224, classes=1000):
    """The GoogLeNet trunk as a functional ``keras.Model``: the stem,
    nine inception blocks of four towers joined by ``merge(mode=
    "concat")``, global average pooling, dropout, a dense layer and
    log-softmax. Keras has no LRN: the trunk's two
    ``SpatialCrossMapLRN`` are left out."""
    def conv(x, n, k, s=1):
        return K.Convolution2D(n, k, k, activation="relu",
                               border_mode="same", subsample=(s, s))(x)

    def block(x, c1, c3r, c3, c5r, c5, pp):
        pool = K.MaxPooling2D((3, 3), (1, 1), border_mode="same")(x)
        return K.merge([conv(x, c1, 1), conv(conv(x, c3r, 1), c3, 3),
                        conv(conv(x, c5r, 1), c5, 5), conv(pool, pp, 1)],
                       mode="concat")

    def down(x):
        return K.MaxPooling2D((3, 3), (2, 2), border_mode="same")(x)

    a = K.Input(shape=(3, size, size))
    h = down(conv(a, 64, 7, 2))
    h = down(conv(conv(h, 64, 1), 192, 3))
    h = block(h, 64, 96, 128, 16, 32, 32)
    h = down(block(h, 128, 128, 192, 32, 96, 64))
    for cfg in ((192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
                (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64)):
        h = block(h, *cfg)
    h = down(block(h, 256, 160, 320, 32, 128, 128))
    h = block(block(h, 256, 160, 320, 32, 128, 128),
              384, 192, 384, 48, 128, 128)
    h = K.Dense(classes)(K.Dropout(0.4)(K.GlobalAveragePooling2D()(h)))
    return K.Model(input=a, output=K.Activation("log_softmax")(h))


def keras_phase(torch, dev):
    """(b) The Keras API on the card: ``examples/lenet_mnist.py``'s model
    through ``keras.Sequential`` (Adam, sparse categorical cross-entropy,
    accuracy; ``fit(distributed=False)`` on 2,048 synthetic digits, 2
    epochs at batch 64; zero-based labels, the Keras convention), top-1
    on the test digits >= 0.99; then a functional ``keras.Model`` of the
    GoogLeNet trunk at 224 x 224 and 1,000 classes (no LRN), ``class_nll``
    under Adam 1e-4 in f32: the optimizer ``fit`` builds
    (``fit_optimizer``) on one batch of 64 for 26 one-step epochs, timed
    as (a) is (3 warm-up steps, 20 timed by CUDA events, a 3-step
    profiler window), its loss (``evaluate``: the criterion in eval mode)
    finite and lower after than before, then ``predict_classes``."""
    import numpy as np

    from bigdl_tpu_torch import keras as K, nn, optim
    from bigdl_tpu_torch.feature.mnist import load_mnist
    from bigdl_tpu_torch.llm import kernels
    kernels.reset_launch_counts()
    nn.set_seed(0)
    x, y = load_mnist(synthetic_size=2048)
    xv, yv = load_mnist(synthetic_size=512, train=False)
    x, xv = x.reshape(-1, 1, 28, 28), xv.reshape(-1, 1, 28, 28)
    m = K.Sequential()
    m.add(K.Convolution2D(6, 5, 5, activation="tanh",
                          input_shape=(1, 28, 28)))
    m.add(K.MaxPooling2D())
    m.add(K.Convolution2D(12, 5, 5, activation="tanh"))
    m.add(K.MaxPooling2D())
    m.add(K.Flatten())
    m.add(K.Dense(100, activation="tanh"))
    m.add(K.Dense(10, activation="softmax"))
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    t = time.perf_counter()
    m.fit(x, y - 1, batch_size=64, nb_epoch=2, distributed=False,
          device=dev)
    lenet_s = time.perf_counter() - t
    top1 = m.evaluate(xv, yv - 1, batch_size=256, device=dev)[0].result
    check(top1 >= 0.99, f"phase 16 (b): Keras LeNet-5 top-1 {top1} < 0.99")
    cls = m.predict_classes(xv, device=dev)
    check(cls.shape == (512,)
          and abs(float((cls == yv - 1).mean()) - top1) <= 1e-6,
          f"phase 16 (b): predict_classes {cls.shape} disagrees with "
          "evaluate")
    lenet = {"what": "examples/lenet_mnist.py's model, keras.Sequential, "
                     "Adam, sparse_categorical_crossentropy, batch 64, 2 "
                     "epochs of 2,048 synthetic digits",
             "top1": top1, "fit_s": lenet_s}
    _no_port_launches(kernels, "phase 16 (b) LeNet-5")

    batch, warm, timed, prof_steps = 64, 3, 20, 3
    nn.set_seed(0)
    g = _keras_googlenet(K)
    g.compile(optim.Adam(learning_rate=1e-4), "class_nll")
    rng = np.random.default_rng(3)
    xg = rng.random((batch, 3, 224, 224), dtype=np.float32)
    yg = (rng.integers(0, 1000, batch) + 1).astype(np.float32)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    before = g.evaluate(xg, yg, batch_size=batch, device=dev)[0].result
    opt = g.fit_optimizer(xg, yg, batch_size=batch,
                          nb_epoch=warm + timed + prof_steps,
                          distributed=False, device=dev)
    ms, prof, wall = _timed_optimize(torch, opt, warm, timed, prof_steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = g.evaluate(xg, yg, batch_size=batch, device=dev)[0].result
    check(math.isfinite(before) and math.isfinite(after) and after < before,
          f"phase 16 (b): GoogLeNet eval loss {before} -> {after}")
    pc = g.predict_classes(xg[:16], device=dev)
    check(pc.shape == (16,) and pc.min() >= 0 and pc.max() < 1000,
          f"phase 16 (b): predict_classes {pc}")
    counts = _no_port_launches(kernels, "phase 16 (b) GoogLeNet")
    graph = g.module
    return {"lenet": lenet, "googlenet": {
        "what": "keras.Model GoogLeNet trunk (no LRN: Keras has none), "
                "224x224, 1000 classes, f32, batch 64, Adam 1e-4, "
                "class_nll; fit's optimizer, 26 steps on one batch",
        "graph_nodes": len(graph._order),
        "graph_module_nodes": sum(n.module is not None
                                  for n in graph._order),
        "parameters": graph.n_parameters(),
        "step_ms": sum(ms) / len(ms), "step_ms_each": ms,
        "step_ms_median": statistics.median(ms),
        "images_per_s": batch / (sum(ms) / len(ms)) * 1e3,
        "optimize_wall_s": wall, "profile": prof, "peak_mem_gb": peak,
        "eval_loss_before_after": [before, after],
        "port_kernel_launches": counts}}


def ptb_phase(torch, dev):
    """(c) The LSTM language model at the PTB "medium" size
    (``rnn.build_model(10000, 650, 10000, "lstm", 2)``, 35 steps, batch
    20; the paper's dropout left out: the zoo's model has none) on seeded
    random tokens under ``TimeDistributedCriterion(ClassNLLCriterion())``,
    SGD 1.0 with the gradient's L2 norm clipped at 5: 3 warm-up and 10
    timed steps, a 2-step profiler window (ms a step, tokens/s, launches
    a step, idle share); then one f32 step at batch 2 on the card and on
    the CPU. The Python time loop makes this host-bound."""
    import numpy as np

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.models import rnn
    p = PTB_MEDIUM
    warm, timed, prof_steps = 3, 10, 2
    rng = np.random.default_rng(2)
    n = (warm + timed + prof_steps + 1) * p["batch"]
    x = (rng.integers(0, p["vocab"], (n, p["steps"])) + 1).astype(np.float32)
    y = (rng.integers(0, p["vocab"], (n, p["steps"])) + 1).astype(np.float32)

    def build(device):
        return rnn.build_model(p["vocab"], p["hidden"], p["vocab"], "lstm",
                               p["layers"], device=device)

    def crit():
        return nn.TimeDistributedCriterion(nn.ClassNLLCriterion())

    nn.set_seed(0)
    model = build(dev)
    opt = optim.LocalOptimizer(model, (x, y), crit(), p["batch"],
                               optim.Trigger.max_iteration(
                                   warm + timed + prof_steps), device=dev)
    opt.set_optim_method(optim.SGD(1.0))
    opt.set_gradient_clipping_by_l2_norm(5.0)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    ms, prof, wall = _timed_optimize(torch, opt, warm, timed, prof_steps)
    counts = _no_port_launches(kernels, "phase 16 (c)")
    loss = opt.state["loss"]
    check(math.isfinite(loss), f"phase 16 (c): loss {loss}")
    step_ms = sum(ms) / len(ms)
    train = {"what": "PTB medium LSTM LM: 2 x 650, 35 steps, batch 20, "
                     "vocabulary 10,000, f32, SGD 1.0, clip 5, "
                     "LocalOptimizer, a Python time loop",
             "parameters": model.n_parameters(),
             "step_ms": step_ms, "step_ms_each": ms,
             "step_ms_median": statistics.median(ms),
             "tokens_per_s": p["batch"] * p["steps"] / step_ms * 1e3,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
             "final_loss": loss, "optimize_wall_s": wall,
             "host_step_s_mean": opt.metrics.mean("compute"),
             "port_kernel_launches": counts, "profile": prof}
    del model, opt
    xs, ys = x[:2], y[:2]
    nn.set_seed(0)
    parity = _card_vs_cpu(torch, dev, lambda: build("cpu"), xs, ys, crit(),
                          lambda: optim.SGD(1.0), "phase 16 (c) card vs CPU",
                          1e-5, clip=5.0)  # read 2.0e-6 (CPU's own 0)
    return {"train": train, "card_vs_cpu": parity}


def dllib_keras_phase(torch, dev):
    """Phase 16: (a) Inception-v1, (b) the Keras API, (c) the PTB LSTM."""
    t0 = time.perf_counter()
    out = {"phase": "dllib_keras"}
    out["inception"] = inception_phase(torch, dev)
    torch.cuda.empty_cache()
    out["keras"] = keras_phase(torch, dev)
    torch.cuda.empty_cache()
    out["ptb_lstm"] = ptb_phase(torch, dev)
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


# -- phase 17: data-parallel DLlib training over torch.distributed --------------

DP_MODES = (None, "bf16", "int8")
# phase 17 (c): each parameter tensor within this share of its own
# update's largest entry, card against CPU. One step of a wire mode moves
# a gradient element that rounds across a wire step by that step: 2^-8
# of the element for bf16, 1/127 of its block's largest for int8; the
# plain f32 step moves by rounding only. 0.05 is 6x the int8 step.
DP_PER_TENSOR_TOL = 0.05


def _dp_net(nn):
    """The conv + batch-norm net of ``tests/test_torch_distributed.py``."""
    return (nn.Sequential().add(nn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1))
            .add(nn.SpatialBatchNormalization(4)).add(nn.ReLU())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2)).add(nn.Reshape([64]))
            .add(nn.Linear(64, 3)).add(nn.LogSoftMax()))


def _event_steps(torch, opt, warm, timed):
    """``opt.optimize()`` (``warm + timed + 1`` steps) with a CUDA event
    recorded as each step is dispatched: the ms of each timed step, the
    optimize wall s."""
    marks, step = [], opt._train_step

    def timed_step(*a):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return step(*a)

    opt._train_step = timed_step
    t = time.perf_counter()
    opt.optimize()
    wall = time.perf_counter() - t
    return [marks[i].elapsed_time(marks[i + 1])
            for i in range(warm, warm + timed)], wall


def _engine_row(dist, Engine, what):
    check(dist.is_initialized() and dist.get_backend() == "nccl"
          and Engine.world_size() == 1
          and Engine.config().engine_type == "gpu",
          f"{what}: the Engine is not NCCL at world 1: "
          f"{Engine.config()}")
    return {"backend": str(dist.get_backend()),
            "world": Engine.world_size(),
            "mesh": [list(Engine.mesh().mesh_dim_names),
                     list(Engine.mesh().shape)]}


def _keras_fit_default(torch, dev):
    """(a) Phase 16 (b)'s Keras LeNet-5, ``fit`` with its defaults."""
    import torch.distributed as dist

    from bigdl_tpu_torch import keras as K, nn
    from bigdl_tpu_torch.feature.mnist import load_mnist
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.utils.engine import Engine
    check(not Engine.is_initialized(), "phase 17 (a): the Engine is warm")
    kernels.reset_launch_counts()
    nn.set_seed(0)
    x, y = load_mnist(synthetic_size=2048)
    xv, yv = load_mnist(synthetic_size=512, train=False)
    x, xv = x.reshape(-1, 1, 28, 28), xv.reshape(-1, 1, 28, 28)
    m = K.Sequential()
    m.add(K.Convolution2D(6, 5, 5, activation="tanh",
                          input_shape=(1, 28, 28)))
    m.add(K.MaxPooling2D())
    m.add(K.Convolution2D(12, 5, 5, activation="tanh"))
    m.add(K.MaxPooling2D())
    m.add(K.Flatten())
    m.add(K.Dense(100, activation="tanh"))
    m.add(K.Dense(10, activation="softmax"))
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    opt = m.fit_optimizer(x, y - 1, batch_size=64, nb_epoch=2)
    check(type(opt).__name__ == "DistriOptimizer",
          f"phase 17 (a): fit's default built {type(opt).__name__}")
    engine = _engine_row(dist, Engine, "phase 17 (a)")
    t = time.perf_counter()
    opt.optimize()
    fit_s = time.perf_counter() - t
    top1 = m.evaluate(xv, yv - 1, batch_size=256)[0].result
    check(top1 >= 0.99, f"phase 17 (a): Keras LeNet-5 top-1 {top1} < 0.99")
    _no_port_launches(kernels, "phase 17 (a)")
    return {"what": "examples/lenet_mnist.py's model, keras.Sequential, "
                    "fit's defaults (distributed=True, device=None), batch "
                    "64, 2 epochs of 2,048 synthetic digits",
            "optimizer": type(opt).__name__, "engine": engine,
            "top1": top1, "fit_s": fit_s}


def _resnet_modes(torch, dev):
    """(b) ResNet-50 through ``DistriOptimizer`` in each mode and through
    ``LocalOptimizer``, then the three gradient all-reduces alone."""
    import gc

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.models import resnet
    from bigdl_tpu_torch.parallel import collectives as col
    from bigdl_tpu_torch.utils.engine import Engine
    batch, warm, timed = 256, 3, 10
    t = time.perf_counter()
    x, y = _resnet_batches(warm + timed + 1, batch)
    nn.set_seed(0)
    init = {k: v.detach().clone() for k, v in resnet.resnet_imagenet(
        50, 1000, format="NHWC", device="cpu").state_dict().items()}
    setup_s = time.perf_counter() - t
    rows = {}
    kernels.reset_launch_counts()
    # LocalOptimizer first and last: the base is both runs' steps, so a
    # drift over the call does not read as a mode's cost
    for run, mode in enumerate(("local",) + DP_MODES + ("local",)):
        m = resnet.resnet_imagenet(50, 1000, format="NHWC", device="cpu")
        m.load_state_dict(init)
        cls = optim.LocalOptimizer if mode == "local" else \
            optim.DistriOptimizer
        opt = cls(m, (x, y), nn.ClassNLLCriterion(), batch,
                  optim.Trigger.max_iteration(warm + timed + 1), device=dev)
        if mode != "local":
            opt.set_gradient_compression(mode)
        opt.set_optim_method(optim.SGD(0.1, momentum=0.9, weight_decay=1e-4))
        opt.set_input_dtype(torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        ms, wall = _event_steps(torch, opt, warm, timed)
        loss = opt.state["loss"]
        check(math.isfinite(loss), f"phase 17 (b) {mode}: loss {loss}")
        name = (f"LocalOptimizer {'first' if run == 0 else 'last'}"
                if mode == "local" else f"DistriOptimizer {mode or 'plain'}")
        rows[name] = {"step_ms": sum(ms) / len(ms), "step_ms_each": ms,
                      "step_ms_median": statistics.median(ms),
                      "images_per_s": batch / (sum(ms) / len(ms)) * 1e3,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                      "final_loss": loss, "optimize_wall_s": wall}
        if mode == "int8":
            grads = [torch.randn_like(p) for p in m.parameters()]
        del opt, m
        gc.collect()
        torch.cuda.empty_cache()
    # each all-reduce alone on ResNet-50's gradients, timed by events
    # twice: as called (the host's Python over 161 leaves included), and
    # behind a ~25 ms spin of the stream, so the host has queued the whole
    # call before the first event is reached (the device's own time; a
    # profiler window here found no device events late in a full run)
    grp = Engine.data_group()
    alone = {}
    for name, fn in (("all_reduce f32", col.all_reduce),
                     ("compressed_all_reduce bf16",
                      col.compressed_all_reduce),
                     ("quantized_all_reduce int8", col.quantized_all_reduce)):
        times = {"called": [], "device": []}
        for i in range(26):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            spin = i % 2
            if spin:
                torch.cuda._sleep(50_000_000)
            a.record()
            fn(grads, grp, mean=True)
            b.record()
            torch.cuda.synchronize()
            if i >= 6:
                times["device" if spin else "called"].append(
                    a.elapsed_time(b))
        alone[name] = {"ms_median": statistics.median(times["called"]),
                       "device_ms_median": statistics.median(
                           times["device"]), **times}
    n = sum(g.numel() for g in grads)
    del grads
    counts = _no_port_launches(kernels, "phase 17 (b)")
    base = statistics.median(rows["LocalOptimizer first"]["step_ms_each"]
                             + rows["LocalOptimizer last"]["step_ms_each"])
    for r in rows.values():
        r["step_ms_median_vs_local"] = [r["step_ms_median"], base]
    return {"what": "ResNet-50 NHWC 224x224 batch 256, bf16 inputs, SGD 0.1 "
                    "m 0.9 wd 1e-4; 3 warm-up and 10 timed steps each",
            "gradient_elements": n, "setup_s": setup_s, "runs": rows,
            "collective_alone_ms_world1": alone,
            "port_kernel_launches": counts}


def _dp_card_vs_cpu(torch, dev):
    """(c) One f32 step at batch 2 of the conv + BN net in each mode, on
    the card (the Engine's NCCL mesh) and on the CPU (a gloo group of
    the same world), from the same weights: the loss within 1e-5
    (relative), the BN statistics within 1e-4 + 1e-4 |x|, each parameter
    tensor within ``DP_PER_TENSOR_TOL`` of its own update's largest
    entry, plus 1e-7: the conv bias ahead of the batch norm has a
    gradient of rounding noise only (its update ~1e-8), and is reported
    apart by its absolute deviation."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.utils.tree import tree_leaves
    kernels.reset_launch_counts()
    cpu_mesh = DeviceMesh.from_group(dist.new_group(backend="gloo"), "cpu",
                                     mesh_dim_names=("data",))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 2, 8, 8)).astype(np.float32)
    y = np.array([1.0, 3.0], np.float32)
    nn.set_seed(0)
    init = {k: v.detach().clone() for k, v in
            _dp_net(nn).state_dict().items()}
    rows = {}
    for mode in DP_MODES:
        got = {}
        for where in ("card", "cpu"):
            m = _dp_net(nn)
            m.load_state_dict(init)
            opt = optim.DistriOptimizer(
                m, (x, y), nn.ClassNLLCriterion(), 2,
                optim.Trigger.max_iteration(1),
                device=dev if where == "card" else "cpu",
                mesh=None if where == "card" else cpu_mesh)
            opt.set_gradient_compression(mode)
            opt.set_optim_method(optim.SGD(0.1, momentum=0.9))
            opt.optimize()
            got[where] = (opt.state["loss"], m)
        (l_card, card), (l_cpu, cpu) = got["card"], got["cpu"]
        what = f"phase 17 (c) {mode or 'plain'}"
        check(abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu),
              f"{what}: loss {l_card} vs {l_cpu}")
        stats = 0.0
        for a, b in zip(tree_leaves(card.states_dict()),
                        tree_leaves(cpu.states_dict())):
            a = a.cpu()
            d = float((a - b).abs().max())
            check(bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all()),
                  f"{what}: BN statistics differ by {d}")
            stats = max(stats, d)
        per, tiny = [], 0.0
        for (name, w), c in zip(cpu.named_parameters(), card.parameters()):
            w, c = w.detach(), c.detach().cpu()
            upd = float((w - init[name]).abs().max())
            dev_ = float((c - w).abs().max())
            if upd > 1e-6:
                per.append(dev_ / upd)
            else:
                tiny = max(tiny, dev_)
            check(dev_ <= DP_PER_TENSOR_TOL * upd + 1e-7,
                  f"{what}: {name} is {dev_} from the CPU's, its update "
                  f"{upd}")
        rows[mode or "plain"] = {"loss_card_cpu": [l_card, l_cpu],
                                 "bn_stats_max_abs_diff": stats,
                                 "update_dev_max_over_tensors": max(per),
                                 "tiny_update_max_abs_dev": tiny}
    _no_port_launches(kernels, "phase 17 (c)")
    return {"what": "conv(2->4, 3x3) + SpatialBatchNormalization + ReLU + "
                    "pool + Linear(64, 3), f32, batch 2, one SGD 0.1 m 0.9 "
                    "step; the CPU over a gloo group",
            "modes": rows,
            "tolerance": f"loss 1e-5 rel; BN stats 1e-4 + 1e-4 |x|; each "
                         f"parameter within {DP_PER_TENSOR_TOL} of its "
                         "update's max"}


def _quantized_and_convlstm(torch, dev):
    """(d) ``quantize_model(LeNet5())`` and a ``ConvLSTMPeephole``, card
    against CPU."""
    import copy

    import numpy as np

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.feature.mnist import load_mnist, normalize
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.nn import quantized
    nn.set_seed(0)
    cpu = lenet.build_model(10, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    quantized.quantize_model(cpu)
    quantized.quantize_model(card)
    twins = [type(m).__name__ for m in card.modules()
             if isinstance(m, (quantized.Linear,
                               quantized.SpatialConvolution))]
    check(twins.count("SpatialConvolution") == 2
          and twins.count("Linear") == 2,
          f"phase 17 (d): quantize_model gave {twins}")
    for (name, a), b in zip(card.named_buffers(), cpu.buffers()):
        check(torch.equal(a.cpu(), b),
              f"phase 17 (d): {name} on the card differs from the CPU's")
    x = normalize(load_mnist(synthetic_size=64)[0])
    xt = torch.from_numpy(x)
    kernels.reset_launch_counts()
    with torch.no_grad():
        y_card = card.eval()(xt.to(dev)).cpu().numpy()
    launches = dict(kernels.launch_counts())
    counts = {k: v for k, v in launches.items() if v}
    route = kernels.matmul_route(64, 100)
    want = {"int8_matmul": 1, f"int8_matmul_{route}": 1}
    check(counts == want, f"phase 17 (d): launches {counts} != {want}")
    with torch.no_grad():
        y_cpu = cpu.eval()(xt).numpy()
    err = float(np.abs(y_card - y_cpu).max() / np.abs(y_cpu).max())
    same = bool((y_card.argmax(1) == y_cpu.argmax(1)).all())
    check(err <= 2e-2 and same, f"phase 17 (d): quantized LeNet-5 card vs "
          f"CPU rel err {err}, same argmax {same}")

    kernels.reset_launch_counts()
    rng = np.random.default_rng(4)
    nn.set_seed(0)
    lstm = nn.ConvLSTMPeephole(3, 8, 3, 3)
    lstm.load_parameters_dict({k: 0.3 * rng.standard_normal(
        tuple(v.shape)).astype(np.float32)
        for k, v in lstm.parameters_dict().items()})
    card_l = copy.deepcopy(lstm).to(dev)
    xs = rng.standard_normal((2, 4, 3, 16, 16)).astype(np.float32)
    g = rng.standard_normal((2, 4, 8, 16, 16)).astype(np.float32)
    out = {}
    for where, mod, d in (("cpu", lstm, "cpu"), ("card", card_l, dev)):
        mod.train()
        xi = torch.from_numpy(xs).to(d)
        y = mod(xi)
        gi = mod.backward(xi, torch.from_numpy(g).to(d))
        out[where] = [y.detach().cpu(), gi.cpu()] + [
            p.grad.cpu() for p in mod.parameters()]
    rel = []
    for i, (a, b) in enumerate(zip(out["card"], out["cpu"])):
        r = float((a - b).abs().max() / b.abs().max())
        rel.append(r)
        check(r <= (1e-5 if i == 0 else 1e-4),
              f"phase 17 (d): ConvLSTMPeephole tensor {i} card vs CPU "
              f"rel {r}")
    _no_port_launches(kernels, "phase 17 (d) ConvLSTMPeephole")
    return {"quantized_lenet": {"twins": twins, "launches": counts,
                                "launches_all": launches,
                                "card_vs_cpu_rel_err": err,
                                "same_argmax": same, "tol": 2e-2},
            "convlstm": {"what": "ConvLSTMPeephole(3, 8, 3, 3), input "
                                 "2 x 4 x 3 x 16 x 16, f32",
                         "rel_err_out_gradin_gradparams": rel,
                         "tol": "output 1e-5, gradients 1e-4 of the "
                                "largest"}}


def dllib_distributed_phase(torch, dev):
    """Phase 17: (a) Keras ``fit``'s default, (b) ResNet-50 by mode, (c) a
    conv + BN step by mode card against CPU, (d) ``quantize_model`` and
    ``ConvLSTMPeephole`` card against CPU."""
    import torch.distributed as dist

    from bigdl_tpu_torch.utils.engine import Engine
    t0 = time.perf_counter()
    out = {"phase": "dllib_distributed"}
    try:
        out["keras_fit_default"] = _keras_fit_default(torch, dev)
        torch.cuda.empty_cache()
        out["resnet50_modes"] = _resnet_modes(torch, dev)
        torch.cuda.empty_cache()
        out["card_vs_cpu"] = _dp_card_vs_cpu(torch, dev)
        out["quantized_convlstm"] = _quantized_and_convlstm(torch, dev)
    finally:
        Engine.reset()
    check(not dist.is_initialized(),
          "phase 17: the process group outlived the phase")
    out["wall_s"] = time.perf_counter() - t0
    return out


# -- phase 18: detection, Mask R-CNN, the sparse layers, the drives ------------

# (b) card against CPU, same weights, batch 2. Under the default flags
# cuDNN convolves in TF32 (10-bit mantissa: each product's operands
# rounded by up to 2^-11), so the pyramid and the RPN logits, 13 to 16
# convolutions deep, are held to 2e-2 of each level's largest magnitude,
# the LLM logits' limit. With TF32 off the detections: labels and valid
# slots exactly, boxes within 1e-2 pixels, scores 1e-4, masks 1e-3 (the
# CPU parity tests' limits against the JAX model, the scores' doubled).
MRCNN_TF32_TOL = 2e-2
MRCNN_TOL = {"boxes": 1e-2, "scores": 1e-4, "masks": 1e-3}
# (c) the recommender sizes
SPARSE_ROWS = 1 << 20
LOOKUP = dict(dim=64, batch=4096, bag=32)
SPARSE_LINEAR = dict(out=256, batch=4096, nnz=40)
# each output and gradient within this share of its largest magnitude:
# f32 sums in another order (atomics on the card), up to 4096 terms (the
# bias gradient read 1.7e-7 of its largest on an H100)
SPARSE_TOL = 1e-5


def _tf32(torch, matmul, cudnn):
    """Set the two TF32 flags; returns the previous pair."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    return prev


def _mrcnn_timed(torch, fwd, x, warm=3, timed=20):
    """``warm`` then ``timed`` forwards back to back, a CUDA event
    recorded at each dispatch: ms each, then one profiled forward."""
    from torch.profiler import ProfilerActivity, profile as trace
    with torch.inference_mode():
        for _ in range(warm):
            fwd(x)
        torch.cuda.synchronize()
        evs = [torch.cuda.Event(enable_timing=True)
               for _ in range(timed + 1)]
        evs[0].record()
        for i in range(timed):
            out = fwd(x)
            evs[i + 1].record()
        evs[-1].synchronize()
        ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(timed)]
        torch.cuda.synchronize()
        with trace(activities=[ProfilerActivity.CUDA]) as prof:
            fwd(x)
            torch.cuda.synchronize()
    return ms, _device_window(torch, prof, 1), out


def _mrcnn_checks(torch, out, cfg, b, what):
    d, m = cfg.detections_per_img, cfg.mask_size
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    check(shapes == {"boxes": (b, d, 4), "scores": (b, d),
                     "labels": (b, d), "masks": (b, d, m, m)},
          f"{what}: shapes {shapes}")
    bx, sc, lb, mk = (out[k].float() for k in ("boxes", "scores",
                                               "labels", "masks"))
    check(all(bool(torch.isfinite(t).all()) for t in (bx, sc, mk)),
          f"{what}: a value is not finite")
    check(bool(((bx >= 0) & (bx <= cfg.image_size)).all()),
          f"{what}: a box leaves the image")
    check(bool(((mk >= 0) & (mk <= 1)).all()), f"{what}: a mask leaves [0, 1]")
    check(bool(((lb >= 0) & (lb < cfg.num_classes)).all()),
          f"{what}: a label outside [0, {cfg.num_classes - 1}]")
    valid = lb > 0
    check(bool((sc[valid] > cfg.box_score_thresh).all())
          and bool((sc[~valid] == 0).all()),
          f"{what}: scores do not follow the valid slots")
    return int(valid.sum())


def maskrcnn_phase(torch, dev):
    """(a) Mask R-CNN at ``MaskRCNNConfig()`` timed at batches 1 and 8;
    (b) batch 2 card against CPU."""
    import numpy as np

    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.models import maskrcnn as mr
    cfg = mr.MaskRCNNConfig()
    params = mr.init_params(cfg, 0, device=dev)
    rs = np.random.RandomState(0)
    imgs = rs.rand(8, cfg.image_size, cfg.image_size, 3).astype(np.float32)

    def fwd(x):
        return mr.forward(params, cfg, x)

    out = {"what": "Mask R-CNN, MaskRCNNConfig(): 81 classes, 224 x 224, "
                   "backbone (64, 128, 256, 512), FPN 64, 256 / 64 "
                   "proposals, 16 detections, 28 x 28 masks, f32, random "
                   "weights from seed 0",
           "parameters": mr.num_params(params),
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32}}
    kernels.reset_launch_counts()
    for b in (1, 8):
        x = torch.from_numpy(imgs[:b]).to(dev)
        torch.cuda.reset_peak_memory_stats()
        ms, prof, o = _mrcnn_timed(torch, fwd, x)
        n_valid = _mrcnn_checks(torch, o, cfg, b, f"phase 18 (a) batch {b}")
        med = statistics.median(ms)
        out[f"batch{b}"] = {
            "ms_per_forward_median": med, "ms_per_forward_mean":
                statistics.mean(ms), "ms_each": ms,
            "images_per_s": b / med * 1e3, "valid_detections": n_valid,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "profile": prof}
    prev = _tf32(torch, False, True)            # torch's defaults
    try:
        ms, _, _ = _mrcnn_timed(torch, fwd, torch.from_numpy(imgs).to(dev))
    finally:
        _tf32(torch, *prev)
    out["batch8_default_flags_cudnn_tf32"] = {"ms_per_forward_median":
                             statistics.median(ms),
                             "images_per_s": 8 / statistics.median(ms) * 1e3}
    out["port_kernel_launches"] = _no_port_launches(kernels,
                                                    "phase 18 (a)")

    # (b) card against CPU, batch 2, the same weights from one seed
    cpu = mr.init_params(cfg, 0, device="cpu")
    x2 = imgs[:2]
    with torch.inference_mode():
        pyr_c = mr._fpn(cpu, mr._backbone(cpu, torch.from_numpy(x2)))
        rpn_c = mr.rpn_logits(cpu, pyr_c)
        want = mr.forward(cpu, cfg, torch.from_numpy(x2))
        prev = _tf32(torch, False, True)        # torch's defaults
        try:
            xd = torch.from_numpy(x2).to(dev)
            pyr_d = mr._fpn(params, mr._backbone(params, xd))
            rpn_d = mr.rpn_logits(params, pyr_d)
            _tf32(torch, False, False)
            got = mr.forward(params, cfg, xd)
        finally:
            _tf32(torch, *prev)

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    dev_tf32 = {f"P{i + 2}": rel(a, b) for i, (a, b) in
                enumerate(zip(pyr_d, pyr_c))}
    dev_tf32["rpn_scores"] = rel(rpn_d[0], rpn_c[0])
    dev_tf32["rpn_deltas"] = rel(rpn_d[1], rpn_c[1])
    worst = max(dev_tf32.values())
    check(worst <= MRCNN_TF32_TOL,
          f"phase 18 (b): pyramid / RPN logits under TF32 {dev_tf32}")
    check(torch.equal(got["labels"].cpu(), want["labels"]),
          f"phase 18 (b): labels {got['labels'].tolist()} against the "
          f"CPU's {want['labels'].tolist()}")
    check(torch.equal(got["scores"].cpu() > 0, want["scores"] > 0),
          "phase 18 (b): valid slots differ")
    det = {k: float((got[k].cpu() - want[k]).abs().max())
           for k in MRCNN_TOL}
    check(all(det[k] <= MRCNN_TOL[k] for k in MRCNN_TOL),
          f"phase 18 (b): detections {det} against {MRCNN_TOL}")
    _mrcnn_checks(torch, got, cfg, 2, "phase 18 (b)")
    out["card_vs_cpu"] = {
        "batch": 2, "tf32_default_flags_rel_to_max": dev_tf32,
        "tf32_tol": MRCNN_TF32_TOL, "tf32_off_max_abs": det,
        "tol": MRCNN_TOL, "labels_equal": True,
        "valid_slots": int((want["labels"] > 0).sum())}
    return out


def sparse_phase(torch, dev):
    """(c) ``LookupTableSparse`` (2^20 x 64, ids 4096 x 32 with padding,
    each combiner) and ``SparseLinear`` (2^20 -> 256, 40 non-zeros a
    row, batch 4096): forward and forward + backward ms (``time_ms``),
    card against CPU. A forward's bound is its bytes (each used row, the
    ids or the COO triple, the output once): its f32 sums are a few
    operations a byte."""
    import numpy as np

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.tensor import SparseTensor
    rs = np.random.RandomState(0)
    out = {}
    kernels.reset_launch_counts()

    def close(what, got, want):
        err = float((got.detach().cpu() - want.detach()).abs().max())
        scale = float(want.detach().abs().max())
        check(err <= SPARSE_TOL * scale,
              f"phase 18 (c) {what}: card against CPU {err} "
              f"(largest {scale})")
        return err / scale

    L = LOOKUP
    ids = rs.randint(1, SPARSE_ROWS + 1, (L["batch"], L["bag"]))
    ids[rs.rand(L["batch"], L["bag"]) < 0.25] = 0        # padding
    ids_t = torch.from_numpy(ids.astype(np.float32))
    g = torch.from_numpy(rs.randn(L["batch"], L["dim"]).astype(np.float32))
    nn.set_seed(0)
    cpu = nn.LookupTableSparse(SPARSE_ROWS, L["dim"])
    card = copy.deepcopy(cpu).to(dev)
    ids_d, g_d = ids_t.to(dev), g.to(dev)
    for comb in ("sum", "mean", "sqrtn"):
        cpu.combiner = card.combiner = comb
        cpu.weight.grad = card.weight.grad = None
        yc = cpu(ids_t)
        yc.backward(g)
        yd = card(ids_d)
        yd.backward(g_d)
        errs = [close(f"LookupTableSparse {comb}", yd, yc),
                close(f"LookupTableSparse {comb} grad", card.weight.grad,
                      cpu.weight.grad)]
        f_ms = time_ms(lambda: card(ids_d), iters=10)
        fb_ms = time_ms(lambda: card(ids_d).backward(g_d), iters=10)
        rows = int((ids > 0).sum())
        nbytes = rows * L["dim"] * 4 + ids.size * 4 + g.numel() * 4
        out[f"lookup_{comb}"] = {
            "forward_ms": f_ms, "forward_backward_ms": fb_ms,
            "forward_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "err_over_largest_out_grad": errs}
    del cpu, card
    S = SPARSE_LINEAR
    # 40 columns a row, drawn with replacement (a repeat in a row, ~0.1%
    # of rows, is two COO entries, summed as the JAX op sums them)
    rows = np.repeat(np.arange(S["batch"]), S["nnz"])
    cols = rs.randint(0, SPARSE_ROWS, rows.size)
    vals = rs.randn(rows.size).astype(np.float32)
    idx = np.stack([rows, cols], 1).astype(np.int32)
    xc = SparseTensor(idx, vals, (S["batch"], SPARSE_ROWS), device="cpu")
    xd = xc.to(dev)
    g = torch.from_numpy(rs.randn(S["batch"], S["out"]).astype(np.float32))
    nn.set_seed(0)
    cpu = nn.SparseLinear(SPARSE_ROWS, S["out"])
    card = copy.deepcopy(cpu).to(dev)
    yc = cpu(xc)
    yc.backward(g)
    g_d = g.to(dev)
    yd = card(xd)
    yd.backward(g_d)
    errs = [close("SparseLinear", yd, yc),
            close("SparseLinear weight grad", card.weight.grad,
                  cpu.weight.grad),
            close("SparseLinear bias grad", card.bias.grad, cpu.bias.grad)]
    f_ms = time_ms(lambda: card(xd), iters=10)
    fb_ms = time_ms(lambda: card(xd).backward(g_d), iters=10)
    nnz = rows.size
    out["sparse_linear"] = {
        "forward_ms": f_ms, "forward_backward_ms": fb_ms,
        "forward_bound_ms": (nnz * (S["out"] * 4 + 12)
                             + S["batch"] * S["out"] * 4)
        / HBM_BYTES_PER_S * 1e3,
        "err_over_largest_out_wgrad_bgrad": errs}
    out["tol"] = SPARSE_TOL
    out["port_kernel_launches"] = _no_port_launches(kernels, "phase 18 (c)")
    return out


def drives_phase(torch, dev):
    """(d) The ``--chaos``, ``--kvcache`` and ``--kvtier`` drives on the
    card, each passing its own contract; the port's launch counts of
    each, zeroed just before it."""
    from bigdl_tpu_torch.llm import chaos, kernels
    out = {}
    for name, run in (("chaos", chaos.run_chaos),
                      ("kvcache", chaos.run_kvcache_chaos),
                      ("kvtier", chaos.run_kvtier_chaos)):
        kernels.reset_launch_counts()
        t = time.perf_counter()
        rec = run(device=dev)
        rec["wall_s"] = time.perf_counter() - t
        rec["launches"] = kernels.launch_counts()
        check(rec["match"], f"phase 18 (d) {name}: {rec}")
        out[name] = rec
    return out


def detection_sparse_phase(torch, dev):
    """Phase 18: (a), (b) Mask R-CNN; (c) the sparse layers; (d) the
    training, prefix-cache and host-tier chaos drives."""
    t0 = time.perf_counter()
    out = {"phase": "detection_sparse", "wall_s_by_part": {}}
    for key, part in (("maskrcnn", maskrcnn_phase),
                      ("sparse", sparse_phase), ("drives", drives_phase)):
        t = time.perf_counter()
        out[key] = part(torch, dev)
        out["wall_s_by_part"][key] = time.perf_counter() - t
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


# The caching allocator's split limit, set before torch starts. A
# thread's or a stream's first cuBLAS call takes a 32 MiB workspace from
# the allocator and holds it for the rest of the process. Without a
# limit it may be cut from a large block just freed and still cached (a
# served model's KV pool), and the whole segment then stays reserved
# past ``empty_cache``: a later phase's 14 GiB weight stack no longer
# fits. Blocks of 512 MiB or more are never split under the limit.
ALLOC_CONF = "max_split_size_mb:512"

# (allocated, reserved) in bytes after each ``release_memory``
RELEASES = []


def release_memory(torch):
    """Between phases: collect Python's reference cycles (a model held in
    one by a captured graph or a server thread's closure is freed only by
    the cycle collector, whose timing moves with every import), then give
    the allocator's free blocks back, so the next phase's large weights
    find contiguous memory. Records what stays reserved in ``RELEASES``."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    RELEASES.append((torch.cuda.memory_allocated(),
                     torch.cuda.memory_reserved()))


def main() -> int:
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")
    if "max_split_size_mb" not in conf:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = ",".join(
            c for c in (conf, ALLOC_CONF) if c)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from bigdl_tpu_torch.llm import kernels
        from bigdl_tpu_torch.llm.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    built = kernels.build_kernels()
    ptxas = {n: ptxas_report(_build.build_log(n))
             for n in kernels.KERNEL_SOURCES}
    emit({"phase": "build", "seconds": built,
          "wall_s": time.perf_counter() - t0, "ptxas": ptxas})
    for n in SPILL_FREE:
        rep = ptxas[n]
        check(rep["kernels"] and all(
            k.get("spill_stores", 1) == 0 and k.get("spill_loads", 1) == 0
            for k in rep["kernels"].values()), f"{n}: a spill: {rep}")
    for n in TC_SOURCES:
        check(not any("C7520" in w or "C7514" in w
                      for w in ptxas[n]["warnings"]),
              f"{n}: wgmma serialised: {ptxas[n]['warnings']}")

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = (int4_cases(torch, dev, gen) + lowbit_cases(torch, dev, gen)
             + paged_cases(torch, dev, gen) + ragged_cases(torch, dev, gen)
             + paged_norm_cases(torch, dev, gen))
    for c in cases:
        emit(c)
    sweep = route_sweep(torch, dev, gen)
    emit({"phase": "route_sweep", "tc_min_m": kernels.TC_MIN_M,
          "rows": sweep})
    fcases = family_cases(torch, dev, gen)
    for c in fcases:
        emit(c)
    cases += fcases
    bad = [c["case"] for c in cases + sweep if not c["passed"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")

    ref = reference_check(torch, dev)
    emit(ref)
    ref_glm = reference_check(torch, dev, "glm4_9b")
    emit(ref_glm)
    release_memory(torch)
    serve, model = serve_7b(torch, dev)
    emit(serve)
    cache = serve_prefix_cache(torch, model)
    emit(cache)
    mixed = serve_mixed(torch, model)
    emit(mixed)
    spec = serve_spec(torch, model)
    emit(spec)
    pri = serve_priority(torch, model)
    emit(pri)
    tier = serve_kvtier(torch, model, pri)
    emit(tier)
    prof = profile_decode(torch, model)
    emit(prof)
    mprof = profile_mixed(torch, model)
    emit(mprof)
    sprof = profile_spec(torch, model)
    emit(sprof)
    release_memory(torch)
    slot = serve_slotted(torch, model, serve, serve["outputs"])
    emit(slot)
    slot_prof = profile_slotted(torch, model)
    emit(slot_prof)
    http = serve_http(torch, model, serve)
    emit(http)
    router = serve_router(torch, model, serve, http)
    emit(router)
    fleet = serve_fleet(torch, model, serve, http)
    emit(fleet)
    tools = tools_phase(torch, model)
    emit(tools)
    del model
    release_memory(torch)
    bert, bert_prof = bert_path(torch, dev)
    emit(bert)
    emit(bert_prof)
    formats = formats_phase(torch, dev)
    emit(formats)
    release_memory(torch)
    gen_row, gen_prof = generate_phase(torch, dev)
    emit(gen_row)
    emit(gen_prof)
    release_memory(torch)
    ckpt = checkpoint_check(torch, dev)
    emit(ckpt)
    release_memory(torch)
    glm, glm_prof = glm_phase(torch, dev)
    emit(glm)
    emit(glm_prof)
    release_memory(torch)
    mix = mixtral_phase(torch, dev)
    emit(mix)
    release_memory(torch)
    fam = family_phase(torch, dev)
    emit(fam)
    release_memory(torch)
    dllib = dllib_phase(torch, dev)
    dllib["nvidia_smi"] = smi
    emit(dllib)
    release_memory(torch)
    dllib_keras = dllib_keras_phase(torch, dev)
    dllib_keras["nvidia_smi"] = smi
    emit(dllib_keras)
    release_memory(torch)
    dllib_dist = dllib_distributed_phase(torch, dev)
    dllib_dist["nvidia_smi"] = smi
    emit(dllib_dist)
    release_memory(torch)
    det = detection_sparse_phase(torch, dev)
    det["nvidia_smi"] = smi
    emit(det)

    # launches on each path, each read with the counts zeroed just before
    paths = {"serve_7b": dict(serve["launches"]),
             "serve_7b depth 1": dict(serve["depth1"]["launches"]),
             "serve_7b f32 cache": dict(serve["f32_cache"]["launches"]),
             "serve_7b prefix cache off": dict(cache["off"]["launches"]),
             "serve_7b prefix cache on": dict(cache["on"]["launches"])}
    for r in (mixed["split"], mixed["mixed"]):
        paths[f"serve_7b {r['what'][3:]}"] = dict(r["launches"])
    for r in [spec[n][k] for n in ("alone", "beside 7")
              for k in ("off", "on")] + [pri["off"], pri["on"]]:
        paths[f"serve_7b {r['what'][3:]}"] = dict(r["launches"])
    for r in (tier["off"], tier["on"], tier["priority"]):
        paths[f"serve_7b {r['what'][3:]}"] = dict(r["launches"])
    paths["serve_7b over HTTP"] = dict(http["launches"])
    paths["serve_7b through the router"] = dict(router["launches"])
    paths["serve_7b through the router, failover streamed"] = dict(
        router["launches_failover"])
    for seg, label in (("burst", "routed burst and scale-out, with the "
                                 "new engine's warm-up"),
                       ("two_engines", "routed to two engines"),
                       ("survivor_hit", "the survivor's prefix hit, routed"),
                       ("shipped", "the shipped provider, controller "
                                   "thread")):
        paths[f"serve_7b fleet: {label}"] = dict(
            fleet["fleet"]["segments"][seg]["launches"])
    for name in ("native", "openai streamed"):
        paths[f"serve_7b under loadgen, {name}"] = dict(
            tools["load"][name]["launches"])
    paths["serve_7b under loadgen, through the federated router"] = dict(
        tools["fleet_report"]["routed"]["launches"])
    for name, row in bert["pipelines"].items():
        paths[f"bert {name}"] = dict(row["launches"])
    for name, row in gen_row["runs"].items():
        paths[f"generate {row['what']}"] = dict(row["launches"])
    paths["paged_attention() on generate pools"] = dict(
        gen_row["pool_identity"]["launches"])
    for row in glm["generate"].values():
        paths[f"generate {row['what']}"] = dict(row["launches"])
    paths["serve GLM-4-9B"] = dict(glm["serve"]["launches"])
    paths["serve GLM-4-9B depth 1"] = dict(glm["serve"]["depth1"]["launches"])
    paths["serve_7b slot-static"] = dict(slot["launches"])
    paths["serve_7b slot-static depth 1"] = dict(slot["depth1"]["launches"])
    for name, row in mix["generate"].items():
        paths[f"generate Mixtral {name}"] = dict(row["launches"])
    for f, row in mix["serve"].items():
        paths[f"serve Mixtral factor {f}"] = dict(row["launches"])
        paths[f"serve Mixtral factor {f} depth 1"] = dict(
            row["depth1"]["launches"])
    for name, row in mix["engine_modes"].items():
        paths[f"serve Mixtral {name}"] = dict(row["launches"])
    for name in FAMILIES:
        r = fam[name]
        if "generate" in r:
            paths[f"generate {r['generate']['what']}"] = dict(
                r["generate"]["launches"])
        if "serve" in r:
            paths[f"serve {name}"] = dict(r["serve"]["launches"])
        for m in r.get("engine_modes", {}).values():
            paths[f"serve {m['what']}"] = dict(m["launches"])
        for kv in ("on", "off"):
            if "prefix_cache" in r:
                paths[f"serve {name} prefix cache {kv}"] = dict(
                    r["prefix_cache"][kv]["launches"])
    paths["quantize_model LeNet-5 forward, batch 64"] = dict(
        dllib_dist["quantized_convlstm"]["quantized_lenet"]["launches_all"])
    for name, rec in det["drives"].items():
        paths[f"the --{name} chaos drive, tiny Llama f32"
              if name != "chaos" else "the --chaos drive (LeNet-5)"] = \
            dict(rec["launches"])

    # a two-kernel wrapper's count covers both routes: a dequant-matmul's
    # calls are its GEMV and tensor-core launches, ragged prefill's
    # CUDA-core launches the calls less those on the tensor cores
    for p, n in paths.items():
        for w in MATMUL_KERNELS:
            check(n[w] == n[f"{w}_tc"] + n[f"{w}_gemv"],
                  f"{p}: {w} calls are not its two routes' launches: {n}")
        n["ragged_prefill_attention"] -= n["ragged_prefill_attention_tc"]
    heads = {"int4_matmul_gemv": ("qkv_proj M=8 K=4096 N=12288",
                                  "bigdl_tpu_torch/csrc/lowbit_gemv.cu",
                                  "bigdl_tpu/llm/kernels/int4_matmul.py:220"),
             "int4_matmul_tc": ("Mistral gate_up_proj M=2048",
                                "bigdl_tpu_torch/csrc/int4_matmul_tc.cu",
                                "bigdl_tpu/llm/kernels/int4_matmul.py:220"),
             "asym_int4_matmul_gemv": (
                 "BERT pooler M=8", "bigdl_tpu_torch/csrc/lowbit_gemv.cu",
                 "bigdl_tpu/llm/kernels/int4_matmul.py:287"),
             "asym_int4_matmul_tc": (
                 "BERT ffn2 M=1024",
                 "bigdl_tpu_torch/csrc/lowbit_matmul_tc.cu",
                 "bigdl_tpu/llm/kernels/int4_matmul.py:287"),
             "int8_matmul_gemv": (
                 "BERT pooler M=8", "bigdl_tpu_torch/csrc/lowbit_gemv.cu",
                 "bigdl_tpu/llm/kernels/int4_matmul.py:334"),
             "int8_matmul_tc": (
                 "BERT ffn2 M=1024",
                 "bigdl_tpu_torch/csrc/lowbit_matmul_tc.cu",
                 "bigdl_tpu/llm/kernels/int4_matmul.py:334"),
             "paged_attention_decode_stats": (
                 "7B decode", "bigdl_tpu_torch/csrc/paged_attention.cu",
                 "bigdl_tpu/llm/kernels/paged_attention.py:377"),
             "ragged_prefill_attention_tc": (
                 "7B prefill", "bigdl_tpu_torch/csrc/ragged_prefill_tc.cu",
                 "bigdl_tpu/llm/kernels/ragged_prefill.py:189"),
             "ragged_prefill_attention": (
                 "7B prefill f32 cache",
                 "bigdl_tpu_torch/csrc/ragged_prefill.cu",
                 "bigdl_tpu/llm/kernels/ragged_prefill.py:189"),
             "paged_attention_decode": (
                 "Mistral decode", "bigdl_tpu_torch/csrc/paged_attention.cu",
                 "bigdl_tpu/llm/kernels/paged_attention.py:260")}
    summary = []
    for name, (case, src, replaces) in heads.items():
        wrapper = name.removesuffix("_tc").removesuffix("_gemv")
        c = next(c for c in cases
                 if c["kernel"] == name and c["case"].startswith(case))
        by_path = {p: n[name] for p, n in paths.items() if n[name]}
        check(by_path, f"{name} never ran on a path: {paths}")
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "case": c["case"], "route_rule": (
                f"M >= TC_MIN_M={kernels.TC_MIN_M} and N % 16 "
                f"== 0 take {wrapper}_tc (tile: 64x64 while "
                f"ceil(M/64)*ceil(N/64) <= 2*{kernels.TC_SMS}, else "
                "64x128 for M <= 64, else "
                + ("64x64" if wrapper == "asym_int4_matmul" else "128x128")
                + f"), else {wrapper}_gemv (K slices: gemv_slices(K, N))"
                if wrapper in MATMUL_KERNELS else
                "bf16 q and pools, D % 16 == 0, D <= 128, page % 8 == 0 "
                "take ragged_prefill_attention_tc, else "
                "ragged_prefill_attention"
                if wrapper == "ragged_prefill_attention" else None),
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "passed": all(x["passed"] for x in cases
                          if x["kernel"] == name)})
    # what the graph gives (eager step against the graphed step, profiled)
    # and what the depth gives (served at depth 1 against depth 2); the 7B
    # served step's idle share against the profiled graphed step's device
    # time (the same step: batch 8, 32 layers)
    host_out = {}
    for name, prof_row, runs in (
            ("7B served", prof, {"depth1": serve["depth1"], "depth2": serve}),
            ("GLM-4-9B served", glm_prof,
             {"depth1": glm["serve"]["depth1"], "depth2": glm["serve"]}),
            ("Mistral-7B generate (a)", gen_prof,
             {"generate": gen_row["runs"]["a"]}),
            ("GLM-4-9B generate", glm_prof,
             {"generate": glm["generate"]["paged"]})):
        host_out[name] = {
            "profiled": prof_row["what"],
            "eager_step_wall_ms": prof_row["step_wall_ms"],
            "graphed_step_wall_ms": prof_row["graph"]["step_wall_ms"],
            "graphed_step_busy_ms": prof_row["graph"]["device_busy_ms"],
            **{f"{run}_{k}": r[k] for run, r in runs.items()
               for k in ("decode_step_ms", "decode_tok_per_s",
                         "ttft_ms_mean") if k in r}}
    busy = prof["graph"]["device_busy_ms"]
    for d, r in (("depth1", serve["depth1"]), ("depth2", serve)):
        host_out["7B served"][f"{d}_idle_share_vs_profiled_busy"] = (
            1 - busy / r["decode_step_ms"] if busy else None)
    host_out["7B mixed pass"] = {
        "profiled": mprof["what"],
        "eager_pass_wall_ms": mprof["step_wall_ms"],
        "graphed_pass_wall_ms": mprof["graph"]["step_wall_ms"],
        "graphed_pass_busy_ms": mprof["graph"]["device_busy_ms"],
        "graphed_host_calls_by_name":
            mprof["graph"]["host_launch_calls_by_name"],
        "dispatch_host_calls_per_pass":
            mprof["graph"]["dispatch_host_calls_per_pass"],
        **{f"{m}_{k}": mixed[m][k] for m in ("split", "mixed")
           for k in ("long_ttft_ms", "rows_tok_per_s_in_window",
                     "rows_max_gap_ms_in_window")},
        **{f"prefix_cache_{k}": cache[k] for k in ("ttft_ms_mean_on_off",
                                                   "ttft_ms_max_on_off")}}
    host_out["7B verify pass"] = {
        "profiled": sprof["what"],
        "eager_pass_wall_ms": sprof["step_wall_ms"],
        "graphed_pass_wall_ms": sprof["graph"]["step_wall_ms"],
        "graphed_pass_busy_ms": sprof["graph"]["device_busy_ms"],
        "graphed_idle_share": sprof["graph"]["device_idle_share"],
        "graphed_host_calls_by_name":
            sprof["graph"]["host_launch_calls_by_name"],
        "dispatch_host_calls_per_pass":
            sprof["graph"]["dispatch_host_calls_per_pass"],
        **{f"{n} spec {k}_{m}": spec[n][k][m]
           for n in ("alone", "beside 7") for k in ("on", "off")
           for m in ("spec_row_tok_per_s", "aggregate_tok_per_s")}}
    host_out["7B preemption"] = {
        "interactive_ttft_ms_on_off": [pri["on"]["interactive_ttft_ms"],
                                       pri["off"]["interactive_ttft_ms"]],
        "victim_max_gap_ms_on_off": pri["victim_max_gap_ms_on_off"],
        "preemptions": pri["on"]["preemptions_total"],
        "resume_tokens_reused": pri["on"]["resume_tokens_reused"]}
    host_out["7B host KV tier"] = {
        **{f"{k}_on_off": [tier["on"][k], tier["off"][k]] for k in (
            "pass2_ttft_ms_mean", "pass1_ttft_ms_mean",
            "prefix_tokens_reused", "peak_mem_gb")},
        **{k: tier["on"][k] for k in (
            "spills", "fetches", "fetch_wait_ms_mean", "fetch_mb_per_s",
            "arena_pinned_mb")},
        **{f"handoff_{k}": tier["on"]["handoff"][k] for k in (
            "blob_mb", "export_ms", "import_ms")},
        "preempt_exported_mb": tier["priority"]["exported_mb"]}
    host_out["7B slot-static served"] = {
        "profiled": slot_prof["what"],
        "eager_step_wall_ms": slot_prof["step_wall_ms"],
        "graphed_step_wall_ms": slot_prof["graph"]["step_wall_ms"],
        "graphed_step_busy_ms": slot_prof["graph"]["device_busy_ms"],
        "graphed_host_calls_per_step":
            slot_prof["graph"]["host_launch_calls_per_step"],
        **{f"{d}_{k}": r[k] for d, r in (("depth2", slot),
                                          ("depth1", slot["depth1"]))
           for k in ("decode_step_ms", "decode_tok_per_s", "ttft_ms_mean",
                     "peak_mem_gb")},
        **{f"paged_{k}": v for k, v in slot["paged"].items()}}
    mstep = mix["step"][str(MIXTRAL_FACTORS[0])]
    host_out["Mixtral served"] = {
        "profiled": mstep["graph"]["what"],
        "graphed_step_wall_ms": mstep["graph"]["step_wall_ms"],
        "graphed_step_busy_ms": mstep["graph"]["device_busy_ms"],
        "graphed_host_calls_per_step":
            mstep["graph"]["host_launch_calls_per_step"],
        **{f"factor {f} {d}_{k}": r[k] for f, r0 in mix["serve"].items()
           for d, r in (("depth2", r0), ("depth1", r0["depth1"]))
           for k in ("decode_step_ms", "decode_tok_per_s", "ttft_ms_mean",
                     "idle_share_vs_profiled_busy")}}
    for name in FAMILIES:
        r = fam[name]
        if "serve" in r:
            host_out[f"{name} served"] = {
                "profiled": r["step"]["graph"]["what"],
                "eager_step_wall_ms": r["step"]["step_wall_ms"],
                "graphed_step_wall_ms": r["step"]["graph"]["step_wall_ms"],
                "graphed_step_busy_ms": r["step"]["graph"]["device_busy_ms"],
                "graphed_host_calls_per_step":
                    r["step"]["graph"]["host_launch_calls_per_step"],
                **{k: r["serve"][k] for k in (
                    "decode_step_ms", "decode_tok_per_s", "ttft_ms_mean",
                    "peak_mem_gb", "idle_share_vs_profiled_busy")}}
    host_out["7B served over HTTP"] = {
        **{k: http["stream"][k] for k in (
            "first_chunk_ms_mean", "engine_ttft_ms_mean",
            "aggregate_tok_per_s", "phase3_decode_tok_per_s",
            "phase3_ttft_ms_mean")},
        "overhead_decode_tok_per_s_on_off":
            http["overhead"]["decode_tok_per_s_on_off"],
        "graphed_host_calls_per_pass_on_off": [
            p["host_launch_calls_per_pass"]
            for p in http["overhead"]["profile"][::-1]],
        "watchdog_stalled_503_after_s":
            http["watchdog"]["stalled_503_after_s"],
        "handoff_blob_mb": http["roles"]["blob_mb"]}
    host_out["7B through the router"] = {
        **{f"blocking_{k}": router["blocking"][k] for k in (
            "e2e_ms_mean", "engine_ttft_ms_mean", "aggregate_tok_per_s")},
        "failover_cut_to_next_token_ms":
            router["failover"]["cut_to_next_token_ms"],
        "stall_client_visible_s": router["stall"]["client_visible_stall_s"],
        "bw_util_one_engine_two_engines": [router["roofline"]["bw_util"],
                                           router["roofline_a"]["bw_util"]],
        "bw_util_phase3_expect": router["roofline"]["phase3_expect"],
        "utilization_observe_us_full_window":
            router["roofline"]["observe_us_full_window"]}
    host_out["7B time-series plane and fleet"] = {
        **{f"plane_{k}": fleet["overhead"][k] for k in (
            "decode_tok_per_s_on_off", "host_dispatch_ms_per_step_on_off",
            "sample_now_us_median_of_25")},
        "graphed_host_calls_per_pass_on_off": [
            p["host_launch_calls_per_pass"]
            for p in fleet["overhead"]["profile"][::-1]],
        "alert_storm_to_firing_s": fleet["alerts"]["storm_to_firing_s"],
        "alert_storm_end_to_resolved_s":
            fleet["alerts"]["storm_end_to_resolved_s"],
        "scale_out_s": fleet["fleet"]["scale_out"][
            "pressured_tick_to_joined_s"],
        "drain_ms": fleet["fleet"]["scale_in"]["drain_ms"],
        "shipped_provider_watchdog_trips":
            fleet["fleet"]["shipped_provider"]["watchdog_trips"],
        "survivor_hit_ttft_ms_vs_cold": [
            fleet["fleet"]["prefix_hit"]["ttft_ms_survivor_hit"],
            fleet["fleet"]["prefix_hit"]["ttft_ms_cold"]],
        "save_load_s": [fleet["tools"]["save_s"], fleet["tools"]["load_s"]],
        "cli_tok_per_s": fleet["tools"]["cli"]["tok_per_s"]}
    host_out["7B under the load generator"] = {
        **{f"{name}_{k}": tools["load"][name][k]
           for name in ("native", "openai streamed")
           for k in ("latency_p50_ms", "latency_p99_ms", "achieved_qps",
                     "decode_steps")},
        "fleet_soak_ttft_p99_ms": tools["fleet_soak"]["ttft_p99_ms"],
        "fleet_soak_scale_outs_ins": [tools["fleet_soak"]["scale_outs"],
                                      tools["fleet_soak"]["scale_ins"]],
        "chaos_wall_s_alerts_fleet": [tools["alerts_chaos"]["wall_s"],
                                      tools["fleet_chaos"]["wall_s"]]}
    host_out["BERT-base formats, ms a forward (sym_int4 beside)"] = {
        f: formats["bert"]["pipelines"][f]["ms_vs_sym_int4"]
        for f in FORMATS}
    emit({"phase": "host", "paths": host_out})
    report = {"nvidia_smi": smi, "build": built, "cases": cases,
              "alloc_conf": os.environ["PYTORCH_CUDA_ALLOC_CONF"],
              "memory_between_phases_gib": [
                  [round(a / 2**30, 3), round(r / 2**30, 3)]
                  for a, r in RELEASES],
              "route_sweep": sweep,
              "host": host_out,
              "reference": ref, "reference_glm": ref_glm, "glm": glm,
              "glm_profile": glm_prof,
              "serve": serve, "profile": prof, "bert": bert,
              "serve_prefix_cache": cache, "serve_mixed": mixed,
              "profile_mixed": mprof, "serve_spec": spec,
              "serve_priority": pri, "serve_kvtier": tier,
              "profile_spec": sprof,
              "bert_profile": bert_prof, "generate": gen_row,
              "generate_profile": gen_prof, "checkpoint": ckpt,
              "serve_slotted": slot, "profile_slotted": slot_prof,
              "mixtral": mix, "families": fam, "serve_http": http,
              "router": router, "fleet": fleet, "tools": tools,
              "formats": formats, "dllib": dllib,
              "dllib_keras": dllib_keras,
              "dllib_distributed": dllib_dist,
              "detection_sparse": det,
              "ptxas": ptxas, "kernels": summary}
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
