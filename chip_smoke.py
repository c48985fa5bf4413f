"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. card: its name, and its name and power limit from nvidia-smi;
2. build: every kernel of ``paddle_tpu_torch/csrc`` with nvcc for sm_90a,
   all sources in parallel, with nvcc's register / shared-memory / spill
   report, and the HGMMA (wgmma), UTMALDG (TMA load) and HMMA (mma.sync)
   instructions of each library's SASS: HGMMA and UTMALDG must be nonzero
   in the tensor-core flash forward, dq and dk/dv kernels, HMMA in the
   mma decode, ragged, quant and grid kernels, which must spill nothing;
3. kernel checks: each kernel against its plain PyTorch version on the
   card, in bf16, at the shapes of the Llama-3-8B serving path, with the
   tolerance stated below; the decode kernel at cache indices on the
   edges of its T splits, with and without a window, in bf16, fp16 and
   fp32, each call repeated bit for bit, at a device ``cache_index`` (one
   for all rows and one a row) bit for bit the host-int launch, and
   replayed from a CUDA graph after the index changed in place; the
   ragged paged kernel in bf16
   (mma) and fp32 (simt), with 1, 2 and 4 queries per row, with a window
   and with one long row among short ones, each call on its route by
   count and repeated bit for bit, and replayed from a CUDA graph after
   its seq_lens and tables changed in place. Then fp16: every
   kernel against its plain version at small shapes (the flash forward,
   dq and dk/dv at d 64, 128 and 256; decode, ragged, grid, quant), and
   the counts show the d 128 forward, dq and dk/dv on the wgmma route;
4. kernel times (CUDA events, warmed up, inputs rotated through copies
   larger than the 50 MB L2 so each call finds them cold, as the serving
   path does): the kernel, its plain version, one PyTorch call computing
   the same function as a yardstick (``scaled_dot_product_attention``;
   the port never calls it) and the least time the card could take; the
   flash forward also at the training shape, decode also for one row
   over an 8192-position cache (decode and quant as device time from a
   CUDA graph of back-to-back calls: their wrappers' host time per call
   exceeds the kernels'; so are ragged and grid), and beside the
   tensor-core kernels the CUDA-core (simt) kernels they replaced on
   bf16, on the same inputs; the ragged kernel also at half and twice its
   chunk of table blocks; the grid kernel beside its PR 4 design and the
   ragged kernel, with its chunks in clusters of 8 and 16, and at two
   weak shapes (one row of 8192 positions; the tick's short rows);
5. a small model against a CPU reference: logits of a prefill and of
   decode steps, fp32, the card (kernels) against the CPU (plain
   versions);
6. the slice: Llama-3-8B at full width and depth with random weights
   from the seed, served through ``Predictor.generate`` on 4 requests of
   512 prompt tokens, 128 new tokens, greedy. Each kernel's launch count
   is set to 0 just before this run and read just after: flash attention
   must run once per layer (32), all on the wgmma route, decode
   attention once per layer and decode step (32 x 127), all on the mma
   route. Each decode step is one replay of the step captured into a
   CUDA graph (its cache index read on the device), whose nodes must
   hold 32 decode kernels; the counts are those nodes times the
   replays. A second greedy call must give the same tokens, and the
   greedy and a seeded sampled stream must be bit for bit the
   uncaptured step's (timed beside it). Last, torch.profiler splits one
   decode step's device time by kernel kind and gives the device's busy
   share of the step, beside the graph's pool;
7. the paged slice, on the same model: ``PagedEngine(model, **PAGED)`` at
   its defaults (the device-resident tick, each tick program captured
   once into a CUDA graph and replayed, ring mode, delta transitions, the
   fused patch queue) serves (a) 24 seeded requests (prompts 32-768,
   32-128 new tokens, 4 sampled, one with a stop sequence, admission
   mid-decode) with the counts set to 0 just before and read just after:
   ragged paged attention must run once per layer and decode tick (32 x
   decode_steps, counted inside the graphs), all on the mma route, and
   never during a prefill, flash and decode attention never; one dispatch
   per tick and prefill. The same submissions through
   ``fused_tick=False`` (the host tick) must give identical tokens and
   logprobs, sampled ones included, and so must a rerun. A profiled
   steady tick must show one graph launch and 32 ragged kernels; the
   steady tick of the graphed engine and of the host tick are timed in
   turns. (b) chunked prefill with the prefix cache: 8 requests sharing
   a 512-token prefix must hit it, and a resubmitted prompt must give its
   cold run's tokens. (c) ``Predictor.serve_stream`` at the defaults over
   a pool too small for its load must preempt and still complete every
   request. TTFT, tick time, tokens/s, peak memory and the graphs' pool
   bytes are printed beside the card.
   Then the speculative ticks (``[spec]`` lines): ``PagedEngine(model,
   spec_tokens=4, spec_ngram=2, **PAGED)`` over 16 requests whose prompts
   repeat a seeded 64-token pattern (128 new tokens; 12 greedy, 4 sampled
   at temperature 0.8, top_p 0.9), with the counts set to 0 just before
   and read just after: (a) ragged attention once per layer and spec
   tick (32 x ticks, counted inside the graph, all on the mma route),
   one dispatch per tick and prefill; a steady spec tick is one dispatch
   and no upload, and its graph holds 32 ragged kernels; (b) every
   greedy stream of the spec engine and of the spec-off default engine
   re-scored by one prefill forward: each emitted token's logit within
   ``TOL_TEACHER`` of its position's maximum; (c) (in phase 3) the
   ragged kernel at T = 5 and T = 9 (two launches) in the engine's
   geometry in bf16 and fp16;
   (d) the JAX tests' LookupStub at head_dim 128: spec streams bit for
   bit the spec-off streams, greedy and sampled, with drafts accepted.
   Printed: tokens/s of both engines, the accept rate and tokens per
   forward, the graph pool, a profiled steady spec tick (its device busy
   share), spec and spec-off ticks in turns, and (in phase 4) the ragged
   kernel's time at the verify's shape beside its bound and SDPA.
   Then the serving gateway (``[gateway]`` lines), on the same model:
   (a) ``Gateway`` over two replicas at the defaults with the tick-phase
   profiler, chunked prefill (128), the prefix cache and a spill arena,
   on the one model, serves 24 HTTP requests (16 SSE, 8 JSON, 4 sampled;
   16 share a 512-token prefix; prompts 520-900, 32-64 new), with the
   counts set to 0 just before and read just after: ragged attention
   once per layer and tick of both replicas (counted inside the graphs,
   all on the mma route), each steady graph holding 32 ragged nodes;
   every stream bit for bit that of a direct engine over the same
   submissions; the prefix cache hit; client TTFT, tokens/s and the
   sizes of ``/healthz``, ``/metrics`` and ``/debugz``; (b) the
   tick-phase split of a steady plain and spec tick (phases summing to
   the wall in every record, the document valid) and profile on/off in
   turns; (c) 1 s of ``/profilez`` under load, which must trace ragged
   kernels; (d) a 128-block pool serving more 512-token prefixes than
   it holds: an evicted prefix restored from the arena (0 failures, no
   recapture, the stream bit for bit the warm engine's), its ms beside
   the cold prefill chunks it saves; (e) ``drain()`` with requests in
   flight: they finish, a new request gets 503, no slot stays held.

   Then the rest of ``generate()`` (``[family]`` lines), on the same
   model, each sub-run with the counts set to 0 just before it and read
   just after: (a) beam search, b 2 x 4 beams (decode at 8 rows), 64
   new, length_penalty 1.2: flash 32, decode 32 x 63 from a graph of 32
   decode nodes, bit for bit its uncaptured run; (b)
   ``ngram_speculative_generate`` on 4 rows repeating a 64-token pattern
   (512 tokens), k 4, ngram 2, 128 new, greedy (each stream within
   ``TOL_TEACHER`` of its re-scored maxima; the verify takes the masked
   cache path, so flash 32 and nothing else) and sampled (bit for bit
   its uncaptured run); (c) ``speculative_generate`` with a draft at
   Llama-3.2-1B's published widths (random weights from the seed), on
   the same prompts, 64 new (cut from 128 for the script's time):
   flash 32 + 16, decode 16 x 5 an iteration at per-row device indices,
   greedy streams within ``TOL_TEACHER``; target forwards and tokens per
   forward printed; (d) ``BatchingPredictor`` over
   ``Predictor.generate``: 16 concurrent submits, every answer bit for
   bit its row of the same batch through ``Predictor.generate``, the
   batches and the queue-wait histogram printed; (e) an HF checkpoint
   (Llama-3-8B widths cut to 2 layers, bf16, two shards and an index,
   written from the seed without the ``safetensors`` package) through
   ``from_pretrained``: every parameter bit for bit
   ``load_jax_state_dict``'s on the same arrays.

   Then the host side of the user paths (``[host]`` lines), on the same
   model: (a) the native runtime (``paddle_tpu_torch/native``) built
   with the card host's compiler (its seconds printed), its staging
   arena, ``gather_stack``, ``gather_pad``, ring and trie tokenizer
   against numpy / Python; (b) a byte-level BPE learned in the script
   from ``HOST_CORPUS`` (no tokenizer files on the card machine; every
   id below 128,256, Llama-3's layout) under ``LLAMA3_SPLIT`` on stdlib
   ``re``: the native merge loop's ids equal the Python loop's and
   ``decode(encode(s)) == s``; ``TextGenerationPipeline`` on the 32-layer
   bf16 model, 4 prompts of different lengths left-padded to a bucket,
   32 greedy new tokens (ms a new token printed; no attention kernel
   launches, a left-padded batch attends densely as in the JAX package):
   each row within ``TOL_TEACHER`` of its teacher-forced re-score, as is
   its solo ``generate()``, and on a small fp32 model each padded row bit
   for bit its solo run; (c) ``ptt.Model(resnet50())`` with AdamW,
   ``nn.CrossEntropyLoss()`` and ``metric.Accuracy(topk=(1, 5))``:
   ``fit`` for 8 steps over ``DataLoader(TensorDataset(seeded images,
   labels), batch_size=32, use_native=True)``, the losses within
   ``TOL_HAPI`` of (expected bit for bit with) the same steps by hand
   under cuDNN deterministic, 8 fused update launches (added to the
   kernels line), BatchNorm's running statistics kept, then
   ``evaluate`` and ``predict`` over native loaders; ms a step and
   images/s printed; (d) the four report tools (``python -m
   paddle_tpu_torch.tools.*``) as subprocesses on the [gateway] phase's
   dumps (its reqtrace and tick-phase rings, series docs and span trace)
   and on (c)'s run dir: every exit 0 with a non-empty summary,
   ``trace_export --check`` clean, ``obs_report --check`` OK.

8. the flash backward (phases run beside 3 and 4): the dq and dk/dv
   kernels against their plain version at sq = sk = 2048 (causal, window
   256, packed segments, non-causal; d 128 and 64; bf16 and fp32; bits
   repeat), ``FlashAttentionFunction`` against autograd through dense
   attention; at the training shape each kernel against its plain
   version again, then their times beside the bounds, each kernel's
   plain version and an SDPA backward (and at head_dim 64, the wgmma
   kernels beside their bounds and SDPA); a small fp32 Llama's Trainer step
   on the card against the CPU (loss and every parameter's update);
9. the training slice: Llama-3-8B at full width with 4 layers (random
   weights from the seed, bf16, AdamW with fp32 masters) through
   ``Trainer`` for 10 steps over 2 seeded [2, 2048] batches. The counts
   are set to 0 just before and read just after: flash forward, dq and
   dk/dv run once per layer and step (40 each, all on the wgmma route),
   decode and ragged never;
   the loss stays finite and falls. Step time, tokens/s, MFU, peak
   memory and a torch.profiler split of one step are printed beside the
   card, then step times with prefetch depth 0 against 2. Last, with
   recompute=True the loss and gradients must equal those without, and
   2 steps must run the flash forward twice per layer and step and give
   the same losses. The Trainer runs at the JAX package's defaults
   (graceful shutdown on), and Adam / AdamW update every tensor in one
   launch of the fused kernel (``csrc/fused_adam.cu``): its count is one a
   step. Beside the kernel checks, the fused update against its plain
   version on the card (``[adam]`` lines: bf16 with fp32 masters and a
   clip, fp32 without masters, fp16 with an inverse loss scale, decay on
   some tensors, a set ``found_inf`` writing nothing, bits repeating) and
   its time at the 4-layer training tensors beside the plain version,
   ``torch.optim.AdamW(fused=True)`` and the bound. The feed A/B has a
   third arm, a DataLoader with two spawned workers. Then (``[resume]``)
   full width cut to 1 layer: 4 steps uninterrupted, a fresh run
   preempted at step 3 (``SystemExit(76)``, a ~17.8 GB checkpoint written
   in the per-rank layout: this rank's pieces under ``r0/``, at a world
   of one the whole state; the write and read seconds and bytes), a
   fresh Trainer resumed to step 4, whose final loss must be within 1e-6
   of the uninterrupted run's; and (``[fp16]``) the 4-layer model in fp16
   with fp32 masters and a GradScaler at its defaults for 10 steps (a
   skipped step must keep every parameter; a forced step at scale 2^40
   must be skipped), through the fp16 wgmma kernels.

10. weight-only quantized serving (the kernel phases run beside 3 and 4):
   the quant kernel against its plain version at every Llama-3-8B
   projection shape, int8 and int4, m in {1, 4, 16, 64} bf16 rows, and
   the grid paged kernel against its plain version (bf16 and fp16 on the
   mma route, fp32 on simt, by count; a window; dead table slots pointing
   outside the pool; bits repeat), against the ragged kernel (bit for bit
   in fp32), and replayed from a CUDA graph; their times (quant at m 4,
   16, 32 and 64); a
   small fp32 Llama quantized to int8 and int4 through ``Predictor``, the
   card against the CPU. Then phase 6's model quantized in place by
   ``Predictor(model, Config().enable_weight_only_quant(8))``: the same
   ``generate`` (graphed as in phase 6, its graph holding 224 quant
   nodes) with quant 7 x 32 x 127 (all on the mma route), flash 32 and
   decode 32 x 127 launches and its numbers next to bf16's;
   ``PagedEngine`` on it at its defaults (graphed ticks) under
   ``PADDLE_TPU_PAGED_ATTN=grid`` (grid once per layer and tick, all on
   the mma route, quant once per projection and tick or short prefill,
   ragged never, counted inside the graphs), the host tick's streams
   bit for bit, a rerun, a profiled steady tick (one graph launch, 32
   grid and 224 quant kernels, the grid attention's device time), and
   the same requests under ``ragged``; last the model rebuilt from the
   seed and quantized to int4, through the same ``generate``.

11. the MoE families (``[moe]`` lines, after the fp16 phase, with
   everything before it freed): the flash forward, decode and ragged
   kernels at ERNIE-4.5's head shape (20 query heads on 4 kv heads,
   GQA group 5; bf16 and fp16) against their plain versions, and their
   times beside SDPA and the bound; ERNIE-4.5-21B-A3B at full width, cut
   to 8 of its 28 layers (``MOE_CUTS``; random bf16 weights drawn on the
   card) through ``Predictor.generate`` (4 x 512 + 64; the
   counts set to 0 just before the greedy run and read just after: flash
   8, decode 8 x 63 from a step graph of 8 decode nodes, all on their
   tensor-core routes; greedy and sampled bit for bit the uncaptured
   step; the stream teacher forced through the model's forward step by
   step; an MoE layer free of host reads under the sync-debug mode; the
   step against the bound of reading every expert's weights; the step's
   device time split into expert products, routing and dispatch,
   attention kernels and the rest), then through ``PagedEngine`` (16
   requests, whole-prompt prefill: ragged 8 x ticks inside the graphs,
   all mma; a profiled steady tick); DeepSeek-V2-Lite's published widths
   (cut to 8 of its 27 layers, ``MOE_CUTS``) built through
   ``config_from_hf`` from a written ``config.json``,
   through ``generate`` (graphed bit for bit uncaptured, MLA's cache
   bytes against a (k, v) cache's); a V3-style variant at the same
   widths with one MTP module through ``mtp_speculative_generate``
   (tokens per forward). Its flash, decode and ragged launches join the
   kernels line's.

12. the multi-device slice (``[parallel]`` lines): (a)
   ``flash_attention_with_lse`` (the function the ring runs a block pair
   through) at the ring's block at Llama-3-8B width (q [1,2048,32,128],
   kv [1,2048,8,128], bf16), causal and not, against its plain twin:
   out and lse of the forward, dq, dk, dv of the backward with a random
   nonzero lse cotangent (folded into delta before the dq and dk/dv
   kernels; the twin forms the dense terms), and the fold alone (dout
   0: dq and dk against the dense lse terms, dv 0), bits repeating, the
   autograd Function equal to the direct calls; its forward time (the
   kernels line's row) beside the twin, SDPA's forward (it returns no
   lse) and the bound, and its backward's; (b) the ring's block math on
   one card: a causal sequence of 4 x 2048 positions, each sp index's
   exact sequence of ``ring_flash_step`` calls and lse merges over the
   blocks the ring hands it, against one ``flash_attention`` over all
   8192 positions (out and the gradients of q, k, v), with the counts
   set to 0 just before and read just after (10 block pairs:
   flash_attention_with_lse 10, its backward 10, all on wgmma), and each
   rank's time against the single call's; (c) ``fleet.init`` at a world
   of one on NCCL, ``fleet.distributed_model`` (DTensor parameters) and
   the Trainer at phase 9's config for 5 steps: the losses bit for bit
   the plain Trainer's, the same launches, and both step times. The
   card machine has one GPU: multi-rank results are proved on the CPU
   (the gloo tests).

13. pipeline and expert parallel training (``[moe-train]`` and ``[pp]``
   lines, last): (a) at a small width (ERNIE's shape cut to 2 layers,
   hidden 256, bf16, every expert chosen) each parameter's gradient
   through the flash kernels within ``TOL_GRAD_REL`` (relative L2) of
   the same weights' through the kernels' plain twins on the card; then
   ERNIE-4.5-21B-A3B at full width cut to 3 layers (layer 0 dense, 2.2
   B params, bf16, AdamW with fp32 masters) through
   ``Trainer(loss_fn=moe_lm_loss)`` for 5 steps on one repeated [2,
   2048] batch, the counts set to 0 just before and read just after
   (flash forward, dq and dk/dv once per layer and step, all on the
   wgmma route at GQA group 5; the fused update once a step): the loss
   finite and falling, at least ``MIN_FREE_GB`` left free at the peak;
   step ms, MFU over the active parameters, peak memory and the last
   step's dropped choices printed; (b) a world-one NCCL mesh naming pp
   (degree 1), Llama-3-8B width at 4 layers, tokens [4, 1, 2048]:
   ``pipeline_functional(1)`` and ``pipeline_functional(1, vpp=2)``
   against the plain accumulated step on the same weights, the loss
   within fp32 rounding and every flat gradient within
   ``TOL_GRAD_REL``, with their launches and times beside the plain
   step's. pp > 1 and ep > 1 need several ranks: the CPU gloo tests
   prove them. The phase's flash, dq, dk/dv and update launches join
   the kernels line's.

14. the serving fleet (``[fleet]`` lines, last): two
   ``paddle_tpu_torch.serving.fleet.replica_main`` processes spawned
   together by ``LocalProcessManager`` (``--model llama3-8b --seed``:
   Llama-3-8B at full width and depth drawn from the seed on the card,
   ``PagedEngine`` at the gateway phase's geometry, warmed and graphed
   before the readiness line) behind a ``FleetFrontend`` in this process;
   the gateway phase's 24 requests through the frontend; once a replica
   holds two greedy SSE streams mid-flight (8 tokens at the client, 24
   to go), it is SIGKILLed. Every answer complete (the streamed tokens
   are the final event's, as many as asked); the streams that never
   failed over bit for bit a direct ``PagedEngine`` on this process's
   own model from the same seed (tokens and logprobs); each greedy
   stream that failed over mid-flight bit for bit that direct engine's
   resume of its committed prefix (``resume_tokens``; where it departs
   from the uninterrupted run is printed with the top-2 margin there:
   the survivor prefills what the dead replica had decoded); at least
   two such streams; at least ``FLEET_MIN_WARM`` of the 15 prefix
   followers routed warm by the frontend's counters. Each replica's
   ragged launches are read from its own ``/debugz`` (the survivor's
   exactly 32 per decode tick of the traffic, all on the mma route) and
   join the kernels line's. Printed: cold start, client TTFT p50/p99,
   tokens/s, failovers and time to resume after the kill; the survivor
   drains on SIGTERM and exits 0, and no process outlives the phase.

15. tensor-parallel serving (``[tp]`` lines, last): (a) the flash
   forward, decode and ragged (T = 1 and the verify's T = 5) kernels at
   every per-rank head count tp serving gives them (Llama-3-70B's 64
   query over 8 kv heads at tp 2, 4 and 8, Llama-3-8B's 32 over 8 at tp
   8: 32/4, 16/2, 8/1 and 4/1 a rank), bf16, against their plain
   versions (``TOL_BF16``), each launch on its tensor-core route by count
   (the ragged kernel once per query window of 32 rows), and their times
   beside the plain versions, SDPA and the bound; the quant kernel at
   Llama-3-70B's per-rank projections at tp 4 (``TP_QUANT``: column
   shards, the fused qkv and gate_up, and the row layers through the
   wrapper's offset into the whole scales table), int8 and int4, m 4
   and 16, against its plain version, timed beside a bf16 matmul on the
   dequantized weight and the bound; (b) Llama-3-8B at full width, cut
   to ``TP_LAYERS`` (8) of its 32 layers, twice from the seed: one
   plain, one sharded on a world-one
   NCCL mesh (``{"tp": 1}``) and bound once (``bind_static``), through
   ``Predictor.generate`` (4 x 512 + ``TP_NEW``, the counts set to 0 just
   before the sharded run and read just after: flash 32, decode 32 x
   (``TP_NEW`` - 1) from the step graph) and the ``PagedEngine`` (chunked
   prefill 128, the prefix cache, a 384-token shared prefix, one sampled
   request of 8, then ``spec_tokens=4``; one graph replay a tick, ragged
   once per layer and tick): tokens (and the engine's logprobs) bit for
   bit the plain model's, step and tick times in turns, one schedule
   digest's host cost (the tp > 1 check's hash; its gloo all-gather
   needs two ranks); (c) ``fuse_projections`` on the
   sharded model in bf16 (its step graph's kernel count and step time
   against the unfused model's, its greedy streams re-scored by the
   unfused model within ``TOL_TEACHER``) and in int8 (the plain model
   sharded and quantized by ``Predictor``: 224 quant nodes a step
   unfused, 128 fused, the unfused streams re-scored by the fused model
   within ``TOL_TEACHER``). At tp 1 every tp collective is the identity:
   the graphs hold no collective, and tp > 1 is proved by the CPU gloo
   tests. The phase's flash, decode, ragged and quant launches join the
   kernels line's.

16. tensor-parallel serving behind the fleet (``[tp-serve]`` lines):
   (a) ``LocalProcessManager(tp=1)`` spawns ``replica_main --tp 1
   --model llama3-8b --layers 8 --seed`` through
   ``paddle_tpu_torch.distributed.launch`` (Llama-3-8B at full width, cut
   to 8 of its 32 layers (``TP_SERVE_LAYERS``), built sharded on a
   world-one NCCL mesh and bound once, its engine behind the
   ``SequencedEngine`` that a tp replica's rank 0 serves: every call
   recorded, encoded, decoded and applied before each step, with no
   collective at tp 1) behind a ``FleetFrontend``; 8 greedy requests
   sharing a 384-token prefix and one sampled: every stream bit for bit a
   direct plain ``PagedEngine`` on this process's own model from the
   seed (tokens and logprobs). Read from the replica's ``/debugz`` over
   the traffic: ragged launches exactly 8 a decode tick (one a layer), all on mma;
   flash launches 0 (the engine's prefill chunks attend through dense
   attention, as phase 11's counts show: flash serves ``generate()``);
   the sequencer's host microseconds a step (record, send, apply).
   Printed: client TTFT p50/p99 and new tokens/s. The replica runs with
   a spill arena and ``--migrate on``: a greedy stream sent to it alone,
   then a SIGTERM after its first tokens; the drain migrates the stream
   (its span banked, named as ``resume_kv``) and ``GET /kvz`` fetches
   that span while the drain's grace holds the port: the decoded K/V
   bit for bit the direct engine's arena record of the same prompt (their
   blocks in common). Every process of the replica exits 0. (b)
   ``from_pretrained`` of the 2-layer full-width Llama-3-8B checkpoint
   (phase 10 (e)'s) inside ``sharded_build`` on a world-one NCCL mesh:
   every parameter bit for bit the whole loader's, with each load's
   seconds and peak card memory. tp > 1 (the broadcast to other ranks, a
   follower's loss, a rank's slices of a checkpoint) is proved by the
   CPU gloo tests. The phase's ragged launches join the kernels line's.

17. the MoE families and MLA served sharded (``[tp-moe]`` lines):
   (a) ERNIE-4.5-21B-A3B at full width and phase 11's depth cut (8
   layers) from phase 11's seed,
   built inside ``sharded_build`` on a world-one ``{"tp": 1, "ep": 1}``
   NCCL mesh and bound once: ``Predictor.generate`` (4 x 512 + 64, the
   counts set to 0 just before and read just after: flash 8, decode 8
   x 63 from the step graph) and the ``PagedEngine`` (phase 11's 16
   requests, whole-prompt prefill: ragged once per layer and tick), each
   stream bit for bit the plain model's that phase 11 recorded before
   freeing it, the decode step and a steady tick beside phase 11's; (b)
   the flash, decode and ragged kernels (T = 1 and 5) at ERNIE's heads
   a rank at tp 2 (10 / 2) and tp 4 (5 / 1), and the quant kernel (int8,
   m 4 and 16) at its per-rank projections (``TP_MOE_QUANT``), each
   against its plain version and timed beside SDPA or the bf16 matmul and
   the bound, and one MoE layer's expert products at E / ep = 64, 32 and
   16; (c) ``LocalProcessManager(tp=1, ep=1)`` spawns ``replica_main
   --tp 1 --ep 1 --model ernie45-21b-a3b --layers 8`` behind a
   ``FleetFrontend``: 8
   greedy requests and one sampled, one after another, every stream
   (tokens and logprobs) bit for bit the plain model's engine at the
   replica's geometry (phase 11, after the same warm-up); ragged 8 a
   tick from its ``/debugz``; new tokens/s and TTFT; a SIGTERM drain,
   every process exiting 0; (d) DeepSeek-V2-Lite's widths (8 layers)
   built sharded on the world-one mesh through ``generate()``, and the
   V3-style variant through ``mtp_speculative_generate``, bit for bit
   phase 11's plain models. tp and ep > 1 are proved by the CPU gloo
   tests. The phase's flash, decode and ragged launches join the kernels
   line's.

18. fine-tuning (``[finetune]`` lines): first the flash forward, dq
   and dk/dv with the packed batch's segment ids at q [2, 2048, 32, 128],
   kv [2, 2048, 8, 128] against their plain versions (on wgmma; timed
   beside the plain versions, SDPA with the same boolean mask and the
   bound of the (query, key) pairs this data needs). Then Llama-3-8B at
   full width and depth from the seed with LoRA (r 8, alpha 16) on all
   seven projections of every layer: (a) 3 ``SFTTrainer`` steps on one
   batch from ``DataCollatorForSFT(max_length=2048, packing=True,
   pack_rows=2)`` over seeded prompt/response pairs of 16-512 tokens,
   the counts set to 0 just before and read just after: flash, dq and
   dk/dv 32 a step, every call with segment ids, on wgmma; the fused
   AdamW once a step with state for the adapters alone; the loss falls;
   every base weight bit for bit its host copy; every B moved; step ms,
   tokens/s, peak memory, a profiled step and the update's time over the
   adapters; (b) each segment of the packed rows against its forward
   alone (padded to whole tiles, on the flash route), within
   ``TOL_PACKED``; (c) at 2 layers, one step's adapter gradients on the
   kernels against the kernels' plain versions, within ``TOL_GRAD_REL``;
   (d) B zeroed, the reference log-probs from ``compute_sequence_logps``
   over the concatenated [2, 1024] pair, 3 ``DPOTrainer`` steps: step 0
   at ln 2 within ``TOL_LN2``, the loss falls; (e) ``generate()`` (2 x 512
   + 32, greedy) on the adapted model, ``merge_lora``, ``generate()``
   again with the counts read (flash 32, decode 32 x 31 on mma): the
   captured step is rebuilt without the adapters' products, each token
   within ``TOL_TEACHER`` of a teacher-forced forward's maximum, the
   logits within ``TOL_MERGE`` of the adapted model's; ``unmerge_lora``
   brings every projection within ``TOL_UNMERGE`` of its host copy; (f)
   merged, ``PTQ`` (2 calibration batches of [1, 512], ``lm_head``
   skipped), ``convert``, ``generate()`` with the counts read (quant 7 x
   32 x 31 on mma), the converted logits on the quant kernel within
   ``TOL_PTQ_PLAIN`` of its plain version, the teacher-forced gap and
   NLL against bf16; (g) the ``[train]`` cut (4 layers, [2, 2048]) with
   every projection in a ``FakeQuantLinear``, 2 Trainer steps. Last,
   decode and the int8 quant kernel timed at (e)'s and (f)'s shapes. The
   phase's launches join the kernels line's, and the segment kernels'
   errors its errors.

19. the model zoo (``[zoo]`` lines, last): (a) the flash forward, dq
   and dk/dv at the slice's new shapes (``ZOO_FLASH``: GPT-1.3B's q [4,
   1024, 16, 128] and GPT-2's [4, 1024, 12, 64] causal, the encoder's
   [8, 256, 8, 64] non-causal) and the quant kernel (int8 and int4, m 4
   and 16) at GPT-1.3B's four projections (``ZOO_QUANT``), each against
   its plain version and timed beside it, SDPA or a bf16 matmul on the
   dequantized weight, and the bound; (b) GPT-1.3B (``GPTConfig()``, 24
   layers, bf16, random weights from the seed) through
   ``Predictor.generate`` on [4, 512] + 128, greedy, the counts set to 0
   just before and read just after: no kernel at all (GPT attends its
   cache densely, outside the kernels, as the JAX module does), the step
   graph holding no attention kernel, bit for bit the uncaptured step,
   the stream within ``TOL_TEACHER`` of a teacher-forced forward; a short
   beam run; (c) the same weights quantized to int8 and to int4 by the
   ``Predictor``: quant 96 a step (96 nodes in the step graph, on mma),
   each stream within ``TOL_TEACHER`` of its own model's teacher-forced
   maxima, its gap under bf16 printed; (d) GPT-1.3B through 3 Trainer
   steps on a repeated [4, 1024] batch: flash, dq and dk/dv 24 a step on
   wgmma, one fused update a step, the loss falling, step ms, tokens/s,
   MFU and a profiled step; (e) GPT-2's widths written by hand from
   seeded bf16 weights as an HF checkpoint, through ``config_from_hf``
   and ``from_pretrained`` (tensors bit for bit), ``generate()`` and one
   Trainer step with flash at d 64; (f) ``ErnieForSequenceClassification``
   at ``ErnieConfig()``: 3 Trainer steps at [32, 128] with a quarter
   padding and dropout 0.1 from the model's generator;
   ``ErnieForMaskedLM`` logits; one ``BertForPretraining`` step at
   ``BertConfig()`` (MLM + NSP); (g) ``nn.TransformerEncoder`` (6 layers,
   512 wide, 8 heads, FFN 2048) at [8, 256] in bf16: an eval forward on
   the flash kernel, then its output and gradients on the flash kernels
   and on their plain versions against the module in fp32 (the kernels'
   error within ``TOL_ZOO_RATIO`` of the plain versions'), and one
   Trainer step. The
   phase's launches join the kernels line's, and (a)'s errors its
   errors.

20. the vision and diffusion families (``[vision]`` lines), bf16,
   seeded weights (every trainable parameter noised: adaLN-Zero starts
   at zero), no attention kernel on this path (the attentions are dense
   plain ops, as the JAX modules' are XLA math): (a) DiT-XL/2
   (``dit_xl_2()``) and the SD VAE through ``DiTPipeline`` under
   ``amp.auto_cast``: 4 labels (8 rows with guidance) at 256 x 256,
   ``VISION_DIT_STEPS`` DDIM steps, each one replay of the captured
   denoising step (replays counted, the graph's nodes counted), the
   latents bit for bit an eager run of the same steps, ms a step against
   its FLOP bound (counted by ``torch.utils.flop_counter``), the VAE
   decode, images/s, peak memory; (b) MMDiT at ``MMDiTConfig()``
   (SD3-medium's widths) with a 16-channel SD VAE through
   ``StableDiffusion3Pipeline``: batch 1, seeded context [1, 333, 4096]
   and pooled [1, 2048], 512 x 512, ``VISION_SD3_STEPS`` steps, the same
   numbers; (g) each family's bf16 forward against its fp32 twin on the
   same weights (TF32 off), and one ``DiTBlock``, one VAE
   ``ResnetBlock`` and one ``ConvBNLayer`` alone, within
   ``TOL_VISION_MODEL`` / ``TOL_VISION_BLOCK``; (f) (a)'s DiT-XL/2 and
   VAE written by hand as diffusers checkpoints (bf16) and loaded with
   ``from_pretrained``: every parameter bit for bit, two pipeline steps
   bit for bit the source pipeline's; (c) a ViT-B/16 eval forward at
   [64, 3, 224, 224] and 3 Trainer steps of its classifier, 3 CLIP
   contrastive steps at batch 64 (text 77); (d) ResNet-50: an eval
   forward and 3 Trainer steps at [64, 3, 224, 224], BatchNorm's running
   statistics untouched by the Trainer and moved by an eager train-mode
   forward, the convolutions' share of a profiled step; (e) DBNet
   (ResNet-18 backbone) forward and 3 ``db_loss`` steps at [4, 3, 640,
   640] on seeded maps, SVTR 3 ``ctc_rec_loss`` steps at [64, 3, 32,
   128] and ``ctc_greedy_decode``. Each Trainer run's counts are set to
   0 just before and read just after: the fused AdamW update once a step
   and (parameter) dtype, nothing else; the losses fall. The phase's
   launches join the kernels line's.

21. the fused-qkv families on a tp mesh (``[tp-zoo]`` lines, last): (b)
   the flash forward, dq and dk/dv at GPT-1.3B's per-rank heads at tp 2
   and tp 4 (q [4, 1024, 8 | 4, 128], causal) and the quant kernel at its
   per-rank projections (``TPZ_QUANT``: the qkv rows of a rank's heads,
   out and fc_out row-split, fc_in column-split; int8 and int4, m = 4),
   each against its plain version and timed beside its library call and
   the bound; then on a world-one NCCL mesh: (a) GPT-1.3B (24 layers)
   twice from the seed, plain and built in ``sharded_build`` (its fused
   qkv tagged as three blocks), through ``generate()`` (4 x 512 + 64) and
   the int8 weight-only ``Predictor`` (96 quant nodes a step graph),
   tokens bit for bit the plain model's, and 3 Trainer steps each ([4,
   1024], AdamW: flash, dq, dk/dv 24 a step, one fused update a step),
   losses bit for bit; (c) ViT-B/16 and DiT-XL/2 (bf16, noised) plain and
   built sharded: an eval forward and a denoising step bit for bit; (d)
   ResNet-50 one Trainer step through the BatchNorm that all-reduces its
   statistics over the data axes: no collective issued at a world of one
   (``nn.norm.stat_reductions``), its parameters bit for bit a step
   through the per-rank statistics. tp > 1 is proved by the CPU gloo
   tests. The sharded runs' launches join the kernels line's.

22. Paddle's layer API (``[api]`` lines): (a) a PaddleNLP-style
   decoder written against the public API only (an ``nn.Layer`` of
   ``nn.Linear`` and ``create_parameter``; ``incubate.nn.functional``'s
   ``fused_rms_norm``, ``fused_rotary_position_embedding`` on cos / sin
   tables gathered at ``position_ids``, ``fused_dot_product_attention(
   is_causal=True)``, ``swiglu`` and ``fused_dropout_add``) at
   Llama-3-8B's widths cut to 4 layers, bf16 [2, 2048], its weights from
   the port's ``LlamaForCausalLM`` layers: outputs and every gradient
   against those layers bit for bit (else within ``TOL_API_REL``), flash,
   dq and dk/dv 4 times a step on the wgmma route, a step timed beside
   the Llama layers' in turns; with an ``attn_mask`` the dense route and
   no flash launch; (b) ``vision.datasets.FakeData`` (256 x 256 x 3)
   through the ImageNet train transforms (seeded): the first batch of a
   0-worker ``io.DataLoader`` equal to the transforms by hand, then a
   2-worker loader (each worker's transforms reseeded from its
   ``WorkerInfo.seed``) into ``Model(vision.resnet50())`` fp32 for 4 fit
   steps, one fused update a step; (c) the beginner example
   (``seed(0)``, an ``nn.Layer`` with ``nn.Flatten``, ``summary``,
   ``Model`` with AdamW, ``F.cross_entropy`` and ``Accuracy``, 2 epochs
   of ``FakeData``, ``evaluate``, ``save``); (d) every function and layer
   ``nn`` gained in this slice on the card against the CPU (fp32, within
   ``TOL_API_SWEEP``), the random ones by their invariants. Its
   launches join the kernels line's.

23. The tensor-level API (``[tensor]`` lines, last), each run with the
   counts set to 0 just before it and read just after: (a) the JAX
   training idiom, ``pure_fn, params = model.functional()`` then
   ``ptt.value_and_grad`` of the causal-LM loss, on ``LlamaForCausalLM``
   at Llama-3-8B's widths cut to 4 layers, bf16 [2, 2048]: the loss and
   every gradient against an eager ``loss.backward()`` on the same model
   and batch bit for bit, else within ``TOL_TENSOR_REL``; flash, dq and
   dk/dv 4 times a call on the wgmma route; then ``ptt.vjp`` over one
   decoder layer with a seeded cotangent against its eager backward;
   both steps timed; (b) ``ptt.vmap`` of ``flash_attention(causal=True)``
   over a mapped axis of 2 (q [2, 2, 2048, 32, 128], k / v 8 heads):
   one forward launch, each slice bit for bit its own call; ``ptt.grad``
   of the mapped sum: one dq and one dk/dv launch, bit for bit the
   slices' eager gradients; ``ptt.jvp`` through the kernel raises; (c)
   a user ``PyLayer`` (a clipped straight-through estimator) in an
   ``nn.Layer``: eager and ``ptt.grad`` gradients equal on the card and
   on the CPU, the card within ``TOL_TENSOR_PYLAYER`` of the CPU;
   ``no_grad`` inside ``ptt.grad`` cuts nothing; (d) every public
   function of ``tensor``, ``linalg``, ``fft``, ``signal``, ``audio``,
   ``sparse`` and ``distribution`` on the card against the CPU at the CPU
   tests' shapes (``tests/tensor_cases.py``) within ``TOL_TENSOR_SWEEP``,
   the signed factorizations by reconstruction, the random ones by
   support and moments. (a)'s and (b)'s launches join the kernels
   line's.

It prints a JSON line of per-kernel numbers (each kernel's route taken
from its wrapper's counts on the main path: ``cuda-wgmma`` for the flash
forward, dq and dk/dv, ``cuda-mma`` for decode, ragged, quant and grid,
``cuda-simt`` for the fused AdamW update, whose launches include phase
20's, ``[host]``'s and ``[api]``'s ``Model.fit``; the flash forward, dq
and dk/dv include ``[api] (a)``'s and ``[tensor]``'s; ``flash_attention_with_lse``'s
launches are the ring's of phase 12),
then the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Without a CUDA
card, or without the ``paddle_tpu_torch`` package beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import weakref

import torch

# peak rates of one H100 SXM (NVIDIA data sheet, dense bf16)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
L2_BYTES = 50 * 2 ** 20

# bf16 kernel vs plain version: both round p and out to bf16 at the same
# points; the sums run in another order and p is rounded against another
# running max. For outputs of magnitude below ~2 that stays within 2e-2.
TOL_BF16 = 2e-2
# fp32 small model, card (kernels, fp32 matmuls without TF32) vs CPU
TOL_SMALL_LOGITS = 2e-3
# the small model's SGD update, card vs CPU, per parameter: within this
# share of the parameter's largest update, plus 1e-6 for the rounding of
# fp32 sums in another order (a sound run differs by < 1e-6 in all)
TOL_SMALL_UPDATE = 1e-3

FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention_fwd.cu"
DECODE_SOURCE = "paddle_tpu_torch/csrc/decode_attention.cu"
FLASH_REPLACES = "paddle_tpu/ops/pallas/flash_attention.py:149"
DECODE_REPLACES = "paddle_tpu/ops/pallas/decode_attention.py:161"
RAGGED_SOURCE = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
RAGGED_REPLACES = "paddle_tpu/ops/pallas/ragged_paged_attention.py:164"
# fp32 kernel vs plain version: the same fp32 sums in another order
TOL_FP32 = 1e-4
# fp16 kernel vs plain version: the bf16 reasons with 3 more bits of
# significand (about 2.5 fp16 steps at magnitude 2, as 2e-2 is for bf16);
# the backward relative to the largest reference gradient
TOL_FP16 = 5e-3
TOL_BWD_FP16 = 1e-2
# the quant kernel in fp16: one fp16 step of the output (2^-10 |ref|)
TOL_QUANT_REL_FP16 = 2.0 ** -10
FLASH_BWD_SOURCE = "paddle_tpu_torch/csrc/flash_attention_bwd.cu"
DQ_REPLACES = "paddle_tpu/ops/pallas/flash_attention.py:375"
DKV_REPLACES = "paddle_tpu/ops/pallas/flash_attention.py:389"
# bf16 backward vs its plain version, relative to the largest reference
# gradient: p and ds are rounded to bf16 at the same points, the sums run
# in another order over up to 2048 keys or 4 x 2048 query rows
TOL_BWD_BF16 = 2e-2
# flash_attention_with_lse's out against its twin, elementwise: 2^-6 |ref|
# (a few bf16 steps of the value) plus 2^-8 max|ref|. At the ring's
# non-causal block |out| is ~0.02, where TOL_BF16 would be as large as
# the values themselves
TOL_LSE_OUT_REL = 2.0 ** -6
TOL_LSE_OUT_ABS = 2.0 ** -8
# the training slice: Llama-3-8B width, 4 layers, [2, 2048] batches
TRAIN_LAYERS = 4
TRAIN_BATCH = (2, 2048)
TRAIN_STEPS = 10
# steps of each run of the feed A/B (prefetch depth 0 against 2)
FEED_STEPS = 6
# the backward's checks (b, s, h, kv) and timing shape (b, s, h, kv, d)
BWD_CHECK = (1, 2048, 8, 2)
BWD_TIME = (2, 2048, 32, 8, 128)
# the serving geometry of the paged phase (KV pool ~2.1 GB in bf16)
PAGED = dict(max_slots=16, block_size=16, max_blocks_per_seq=64,
             num_blocks=1025)
# the speculative phase's engine arguments beside PAGED
SPEC = dict(spec_tokens=4, spec_ngram=2)
# teacher-forced check of a greedy stream (bf16 Llama-3-8B, random
# weights): each emitted token's logit within this of its position's
# maximum logit, when the stream is re-scored by one prefill forward. The
# batched decode and the prefill round the same bf16 activations through
# other kernels and matmul shapes over 32 layers; at logits of magnitude
# ~2-4 a bf16 step is 2^-7 to 2^-6, so 0.125 is 8-16 steps of the logits
# the two paths may differ by in a near tie.
TOL_TEACHER = 0.125
QUANT_SOURCE = "paddle_tpu_torch/csrc/quant_matmul.cu"
QUANT_REPLACES = "paddle_tpu/ops/pallas/quant_matmul.py:67"
GRID_SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
GRID_REPLACES = "paddle_tpu/ops/pallas/paged_attention.py:92"
# Llama-3-8B's projections (din, dout): q/o, k/v, gate/up, down
QUANT_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
# quant kernel vs its plain version, bf16 activations: both dequantize and
# sum in fp32, in another order (warp and split-K partials), and round
# once to bf16, so two nearby fp32 sums may land one bf16 step apart:
# |d| <= 2^-7 |ref| + 1e-3 max|ref| (the second term for elements near 0,
# where the order of the fp32 sums shows)
TOL_QUANT_REL = 2.0 ** -7
TOL_QUANT_ABS = 1e-3
# projections a Llama layer quantizes: q, k, v, o, gate, up, down
QUANT_PER_LAYER = 7
# the kernels redesigned for the tensor cores, by library: their SASS must
# hold HGMMA (wgmma) and UTMALDG (TMA loads)
WGMMA_KERNELS = {"flash_attention_fwd": ("flash_fwd_wgmma_kernel",),
                 "flash_attention_bwd": ("flash_bwd_dq_wgmma_kernel",
                                         "flash_bwd_dkv_wgmma_kernel")}
# the kernels on mma.sync, by library: their SASS must hold HMMA, and
# ptxas must report no spills for them
MMA_KERNELS = {"quant_matmul": ("qmm_mma_kernel",),
               "ragged_paged_attention": ("ragged_mma_kernel",),
               "decode_attention": ("decode_mma_kernel",),
               "paged_attention": ("grid_mma_kernel",)}
# every kernel's launch count, each 0
NO_LAUNCHES = dict.fromkeys(("flash", "decode", "ragged", "flash_bwd_dq",
                             "flash_bwd_dkv", "quant", "grid",
                             "fused_adamw", "flash_lse", "flash_lse_bwd"), 0)
# the fused Adam / AdamW update (csrc/fused_adam.cu). It replaces the
# update XLA fuses inside the JAX package's jitted train step (no
# pallas_call)
ADAM_SOURCE = "paddle_tpu_torch/csrc/fused_adam.cu"
ADAM_REPLACES = ("paddle_tpu/optimizer/optimizers.py:182 (Adam._update, "
                 "XLA-fused in the jitted step; not a pallas_call)")
# kernel vs plain version, max |d| over a tensor against max |ref| of it.
# Both round every fp32 op on its own at the same points, but PyTorch
# divides a CUDA tensor by a Python scalar through its reciprocal, so
# the update may differ by an ulp, and the fp32 master by an ulp of its
# largest element (2^-22 leaves a factor of 2; m and v take no
# division); a 16-bit parameter is the master rounded once, so one step
# of its type where a master's ulp crosses a rounding boundary. (The CPU
# tests hold the plain version to the JAX package's Adam within 1e-6.)
TOL_ADAM = {torch.float32: 2.0 ** -22, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}
# fp32 operations an element of the update, for its bound (the clip's
# multiply, m 3, v 4, the bias-corrected step 5, decay 2, the master 2),
# at the H100's fp32 rate outside the tensor cores
ADAM_OPS = 17
FP32_FLOP_PER_S = 67e12
# the optimizer's device ms in the profiled 4-layer train step before
# this kernel (the per-tensor eager update, as this script's profile
# measured it on an NVIDIA H100 80GB HBM3 at 700 W)
ADAM_BEFORE_MS = "64.42-64.97"
# the resume phase: full width, depth cut to 1 layer (a checkpoint of
# ~17.8 GB: bf16 params, fp32 masters, m and v), 4 steps
# flash attention with lse (the ring's block function): it reaches the
# forward and both backward kernels
LSE_REPLACES = "paddle_tpu/ops/pallas/flash_attention.py:542"
# the ring at Llama-3-8B width on one card: 4 sp blocks of 2048 positions
RING_SP = 4
RING_BLOCK = (1, 2048, 32, 8, 128)      # b, s per rank, h, kv, d
PARALLEL_STEPS = 5

RESUME_LAYERS = 1
RESUME_STEPS = 4
RESUME_PREEMPT = 3
# the resumed run's final loss against the uninterrupted run's (the JAX
# package's tests/test_preemption.py bound)
TOL_RESUME = 1e-6
# the fp16 phase: full width, 4 layers, 10 steps, GradScaler defaults
FP16_STEPS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn(i) over ``iters`` calls, timed with
    CUDA events after ``warmup`` calls."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int, replays: int = 3) -> float:
    """Device milliseconds per call of fn(i), i = 0 .. calls-1, captured
    once into a CUDA graph and replayed: the calls run back to back on the
    card with none of the host's per-call cost. (A kernel shorter than its
    wrapper's host time would otherwise be timed at the host's pace:
    ``cuda_ms`` measures the device's timeline, idle gaps included.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up outside capture
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
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def copies_for(nbytes: int) -> int:
    """How many copies of a call's inputs exceed the L2 cache twice."""
    return max(2, -(-2 * L2_BYTES // max(nbytes, 1)))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------------ phases
def sass_counts(lib) -> dict:
    """{kernel function: (HGMMA, UTMALDG, HMMA)}: the wgmma, TMA-load and
    mma.sync instructions in each function of a built library, from
    cuobjdump's SASS listing."""
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = [0, 0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "UTMALDG" in line
            counts[fn][2] += "HMMA" in line
    return {k: tuple(v) for k, v in counts.items()}


def ptxas_usage(report: str) -> dict:
    """{kernel function: (registers, spill store bytes, spill load bytes)}
    from nvcc's -Xptxas -v report."""
    import re
    usage, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = [0, 0, 0]
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in usage.items()}


def phase_build():
    from paddle_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s (nvcc "
        f"{' '.join(_build.NVCC_FLAGS)})")
    for b in built.values():
        log(f"[build] {b.name}: {b.seconds:.1f} s -> {b.path.name}")
        for line in b.ptxas.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry", "warning",
                                       "Performance", "setmaxnreg")):
                log(f"[ptxas] {b.name}: {line.strip()}")
    # the tensor-core kernels: wgmma and TMA loads, or mma.sync, in the
    # SASS; the mma.sync kernels spill nothing
    for b in built.values():
        counts = sass_counts(b.path)
        total = [sum(c[i] for c in counts.values()) for i in (0, 1, 2)]
        log(f"[sass] {b.name}: HGMMA {total[0]}, UTMALDG {total[1]}, HMMA "
            f"{total[2]} in {len(counts)} functions")
        for fn, (hg, tma, hm) in counts.items():
            if "wgmma_kernel" in fn:
                log(f"[sass] {b.name}: {fn}: HGMMA {hg}, UTMALDG {tma}")
            if "mma_kernel" in fn and "wgmma" not in fn:
                log(f"[sass] {b.name}: {fn}: HMMA {hm}")
        for kernel in WGMMA_KERNELS.get(b.name, ()):
            mine = [c for fn, c in counts.items() if kernel in fn]
            if not mine or not all(hg and tma for hg, tma, _ in mine):
                fail(f"{b.name}: {kernel} lacks HGMMA or UTMALDG in its "
                     f"SASS: {mine}")
        for kernel in MMA_KERNELS.get(b.name, ()):
            mine = [c for fn, c in counts.items() if kernel in fn]
            if not mine or not all(hm for _, _, hm in mine):
                fail(f"{b.name}: {kernel} lacks HMMA in its SASS: {mine}")
            usage = {fn: u for fn, u in ptxas_usage(b.ptxas).items()
                     if kernel in fn}
            if usage:
                regs = sorted({u[0] for u in usage.values()})
                spills = sum(u[1] + u[2] for u in usage.values())
                log(f"[ptxas] {b.name}: {kernel}: {len(usage)} instances, "
                    f"registers {regs[0]}-{regs[-1]}, spill bytes {spills}")
                if spills:
                    fail(f"{b.name}: {kernel} spills: {usage}")


def _simt_fwd(q, k, v):
    """The CUDA-core forward kernel (the route bf16 took before the wgmma
    kernel) on bf16 inputs, causal: for its time beside the new kernel's
    only, outside every counted run."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attention_fwd", "flash_attention_fwd_simt",
                      fa._ARGTYPES)
    _build.check("flash_attention_fwd", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
        lse.data_ptr(), b, sq, k.shape[1], h, k.shape[2], d, d ** -0.5, 1, 0,
        1, torch.cuda.current_stream().cuda_stream))
    return out, lse


def _simt_dkv(q, k, v, dout, lse, delta):
    """The CUDA-core dk/dv kernel on bf16 inputs, causal, as
    ``_simt_fwd``."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    b, sq, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.entry("flash_attention_bwd", "flash_attention_bwd_dkv_simt",
                      fa._DKV_ARGTYPES)
    _build.check("flash_attention_bwd", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), None, dk.data_ptr(), dv.data_ptr(),
        b, sq, k.shape[1], h, k.shape[2], d, d ** -0.5, 1, 0, 1,
        torch.cuda.current_stream().cuda_stream))
    return dk, dv


def _decode_splits_at(q, ck, cv, ci, splits):
    """The decode kernel of the main path's route with ``splits`` blocks
    along T instead of the rule's, for the split-count line only (outside
    every counted run)."""
    from paddle_tpu_torch.ops.kernels import _build, workspace
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    b, h, d = q.shape
    T, kv = ck.shape[1], ck.shape[2]
    work, arrivals = workspace("decode_attention", q.device,
                               b * kv * splits * (h // kv) * (d + 2), b * kv)
    out = torch.empty_like(q)
    fn = _build.entry("decode_attention",
                      f"decode_attention_fwd_{da.decode_route(q.dtype)}",
                      da._ARGTYPES)
    _build.check("decode_attention", fn(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), out.data_ptr(),
        work.data_ptr(), arrivals.data_ptr(), b, T, h, kv, d, ci, None, 0,
        d ** -0.5, 0, splits, da.DTYPES[q.dtype],
        torch.cuda.current_stream().cuda_stream))
    return out


def _simt_dq(q, k, v, dout, lse, delta):
    """The CUDA-core dq kernel on 16-bit inputs, causal, as
    ``_simt_fwd``."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    fn = _build.entry("flash_attention_bwd", "flash_attention_bwd_dq_simt",
                      fa._DQ_ARGTYPES)
    _build.check("flash_attention_bwd", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), None, dq.data_ptr(), b, sq,
        k.shape[1], h, k.shape[2], d, d ** -0.5, 1, 0, fa.DTYPES[q.dtype],
        torch.cuda.current_stream().cuda_stream))
    return dq


def phase_fp16_checks(gen, dev):
    """fp16 through every kernel against its plain version, at small
    shapes: the flash forward, dq and dk/dv at d 64 and 128 (wgmma) and
    256 (simt), causal, with a window and with segments; decode (its
    split edges run in phase_decode_checks); ragged (T 1 and 4), grid
    (dead table slots outside the pool, a window) and quant (int8, int4,
    m 4 and 16). The counts are set to 0 before the flash cases at d 128
    and read after: forward, dq and dk/dv all on the wgmma route."""
    from paddle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_fwd_plain)
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        paged_attention, paged_attention_plain)
    from paddle_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul, quant_matmul_plain)
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain)
    f16 = torch.float16
    for d in (128, 64, 256):
        if d == 128:
            _reset_launches()
        for kw in (dict(causal=True), dict(causal=True, window=100),
                   dict(causal=True, seg=True)):
            kw = dict(kw)
            q, k, v, g, seg = _bwd_inputs(gen, dev, f16, 2, 512, 8, 2, d,
                                          seg=kw.pop("seg", False))
            kw["segment_ids"] = seg
            out, lse = flash_attention_fwd(q, k, v, **kw)
            got = flash_attention_bwd(q, k, v, out, lse, g, **kw)
            torch.cuda.synchronize()
            ref, ref_lse = flash_attention_fwd_plain(q, k, v, **kw)
            want = flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)
            err = max_err(out, ref)
            rel = [max_err(a, r) / max(float(r.float().abs().max()), 1.0)
                   for a, r in zip(got, want)]
            name = ("causal" if seg is None and "window" not in kw
                    else "segments" if seg is not None else "window 100")
            log(f"[fp16] flash d={d} {name} q {list(q.shape)} kv "
                f"{list(k.shape)}: forward max_abs_err {err:.3e} (lse "
                f"{max_err(lse, ref_lse):.3e}; tol {TOL_FP16}), dq/dk/dv "
                f"max |d| / max|ref| " + ", ".join(f"{x:.3e}" for x in rel)
                + f" (tol {TOL_BWD_FP16})")
            if not (err <= TOL_FP16 and max(rel) <= TOL_BWD_FP16):
                fail(f"fp16 flash d={d} {name} disagrees with its plain "
                     f"version")
        if d == 128:
            _check_routes("fp16 d=128", flash=3, flash_bwd_dq=3,
                          flash_bwd_dkv=3)
    b, T, h, kv, d = 4, 640, 32, 8, 128
    q = torch.randn(b, h, d, generator=gen, device=dev).to(f16)
    ck = torch.randn(b, T, kv, d, generator=gen, device=dev).to(f16)
    cv = torch.randn(b, T, kv, d, generator=gen, device=dev).to(f16)
    err = max_err(decode_attention_fwd(q, ck, cv, 600, window=300),
                  decode_attention_fwd_plain(q, ck, cv, 600, window=300))
    log(f"[fp16] decode [4,32,128] over [4,640,8,128] cache_index 600 window"
        f" 300: max_abs_err {err:.3e} (tol {TOL_FP16})")
    if not err <= TOL_FP16:
        fail("fp16 decode disagrees with its plain version")
    B, M = PAGED["block_size"], PAGED["max_blocks_per_seq"]
    for T in (1, 4):
        args = paged_case(gen, dev, ragged_lens(gen, dev, T), T=T, dtype=f16)
        err = max_err(ragged_paged_attention(*args, window=100),
                      ragged_paged_attention_plain(*args, window=100))
        log(f"[fp16] ragged T={T} window 100 q {list(args[0].shape)} pools "
            f"{list(args[1].shape)}: max_abs_err {err:.3e} (tol {TOL_FP16})")
        if not err <= TOL_FP16:
            fail(f"fp16 ragged T={T} disagrees with its plain version")
    q, kp, vp, tbl, sl = paged_case(gen, dev, ragged_lens(gen, dev, 1),
                                    dtype=f16)
    dead = (torch.arange(M, device=dev)[None, :]
            >= ((sl.long() + B) // B)[:, None])
    err = max_err(paged_attention(q, kp, vp, tbl.masked_fill(dead, 1 << 30),
                                  sl, window=100),
                  paged_attention_plain(q, kp, vp, tbl.masked_fill(dead, 0),
                                        sl, window=100))
    log(f"[fp16] grid window 100, dead slots -> 2^30: max_abs_err {err:.3e}"
        f" (tol {TOL_FP16})")
    if not err <= TOL_FP16:
        fail("fp16 grid disagrees with its plain version")
    line = []
    for bits in (8, 4):
        qw, sc = _quantized(gen, dev, 4096, 14336, bits)
        for m in (4, 16):
            x = torch.randn(m, 4096, generator=gen, device=dev).to(f16)
            out = quant_matmul(x, qw, sc, bits)
            ref = quant_matmul_plain(x, qw, sc, bits).float()
            diff = (out.float() - ref).abs()
            ok = bool((diff <= TOL_QUANT_REL_FP16 * ref.abs()
                       + TOL_QUANT_ABS * float(ref.abs().max())).all())
            line.append(f"int{bits} m={m} {float(diff.max()):.3e}")
            if not (ok and out.dtype == f16):
                fail(f"fp16 quant int{bits} m={m} disagrees with its plain "
                     f"version")
    log(f"[fp16] quant gate_proj 4096->14336, fp16 x, bf16 scales: "
        f"max_abs_err " + ", ".join(line) + f" (tol 2^-10 |ref| + "
        f"{TOL_QUANT_ABS} max|ref|)")


def flash_inputs(gen, dev, b, s, h, kv, d):
    q = torch.randn(b, s, h, d, generator=gen, device=dev) * 0.5
    k = torch.randn(b, s, kv, d, generator=gen, device=dev) * 0.5
    v = torch.randn(b, s, kv, d, generator=gen, device=dev)
    return [t.to(torch.bfloat16) for t in (q, k, v)]


def phase_kernel_checks(gen, dev):
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_plain)
    errs = {}
    cases = [("flash main [4,512,32,128] kv 8 causal",
              (4, 512, 32, 8, 128), dict(causal=True)),
             ("flash window=100 [1,256,8,128] kv 2",
              (1, 256, 8, 2, 128), dict(causal=True, window=100)),
             ("flash segment_ids [2,256,8,128] kv 2",
              (2, 256, 8, 2, 128), dict(causal=True, seg=True))]
    for name, shape, kw in cases:
        q, k, v = flash_inputs(gen, dev, *shape)
        if kw.pop("seg", False):
            seg = torch.ones(shape[0], shape[1], dtype=torch.int32,
                             device=dev)
            seg[:, 100:] = 2
            seg[:, -8:] = 0
            kw["segment_ids"] = seg
        out, lse = flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_fwd_plain(q, k, v, **kw)
        err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
        log(f"[check] {name}: max_abs_err {err:.3e} (lse {lse_err:.3e}) "
            f"tol {TOL_BF16}")
        if not (err <= TOL_BF16 and lse_err <= 1e-2):
            fail(f"flash kernel disagrees with its plain version: {name}")
        errs.setdefault("flash", err)

    errs["decode"] = phase_decode_checks(gen, dev)
    return errs


def decode_edges(T, b, kv):
    """(cache_index, window) pairs on the edges of the decode kernel's
    splits on this card: the first position; the last of split 0 and the
    first of split 1; a window from split 0 into split 1; one inside
    split 1; the last position of the cache, with and without a window.
    Returns them with the split count."""
    from paddle_tpu_torch.ops.kernels.decode_attention import decode_splits
    splits = decode_splits(
        T, b * kv, torch.cuda.get_device_properties(0).multi_processor_count)
    c = -(-T // splits)
    return splits, [(0, None), (c - 1, None), (c, None), (c + 10, 20),
                    (2 * c - 1, 5), (T - 1, None), (T - 1, 128)]


def decode_rows_check(q, ck, cv, rows, window, tol, label):
    """The decode kernel at a device ``cache_index`` of one index a row,
    the rows' indices distinct (``rows``): against its plain version on
    the same tensor within ``tol``, and each row bit for bit that row of
    the host-int launch at its own index (a kernel reading another row's
    index fails here). Then a CUDA graph of the launch, replayed after the
    indices changed in place (reversed), the same. Returns the error."""
    from paddle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_fwd_plain)
    ci = torch.tensor(rows, dtype=torch.int32, device=q.device)
    out = decode_attention_fwd(q, ck, cv, ci, window=window)
    torch.cuda.synchronize()
    err = max_err(out, decode_attention_fwd_plain(q, ck, cv, ci,
                                                  window=window))
    if not err <= tol:
        fail(f"decode kernel at per-row indices {rows} window {window} "
             f"disagrees with its plain version ({label}): {err:.3e}")

    def by_row(got, idx):
        for i, r in enumerate(idx):
            if not torch.equal(got[i], decode_attention_fwd(
                    q, ck, cv, r, window=window)[i]):
                fail(f"decode kernel at per-row indices {idx} window "
                     f"{window}: row {i} differs from the host-int launch "
                     f"at {r} ({label})")
    by_row(out, rows)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = decode_attention_fwd(q, ck, cv, ci, window=window)
    ci.copy_(torch.tensor(rows[::-1], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    by_row(g_out, rows[::-1])
    del graph
    return err


def phase_decode_checks(gen, dev):
    """The decode kernels (split along T; mma for bf16 and fp16, simt for
    fp32) against their plain version at the slice's shape (q [4,32,128],
    cache [4,640,8,128]) at cache indices on the edges of the splits, with
    and without a window; each call made twice must give the same bits,
    and so must the call at a device ``cache_index`` (one int32 for all
    rows, and one a row), bit for bit the host-int launch. Distinct
    indices a row (:func:`decode_rows_check`) against the plain version
    and row by row against the host-int launch, also at the draft
    model's shape (d 64). Then a CUDA graph of the device-index launch,
    replayed after the index changed in place, must give the host-int
    launch's bits at each new index. Returns the bf16 error at the last
    position."""
    from paddle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_fwd_plain, decode_route)
    b, T, h, kv, d = 4, 640, 32, 8, 128
    splits, edges = decode_edges(T, b, kv)
    main_err = None
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float16, TOL_FP16),
                       (torch.float32, TOL_FP32)):
        q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
        ck = torch.randn(b, T, kv, d, generator=gen, device=dev).to(dtype)
        cv = torch.randn(b, T, kv, d, generator=gen, device=dev).to(dtype)
        line = []
        for ci, window in edges:
            out = decode_attention_fwd(q, ck, cv, ci, window=window)
            again = decode_attention_fwd(q, ck, cv, ci, window=window)
            torch.cuda.synchronize()
            ref = decode_attention_fwd_plain(q, ck, cv, ci, window=window)
            err = max_err(out, ref)
            line.append(f"{ci}/{window} {err:.3e}")
            if not err <= tol:
                fail(f"decode kernel disagrees with its plain version at "
                     f"cache_index {ci} window {window} ({dtype})")
            if not torch.equal(out, again):
                fail(f"decode kernel does not repeat at cache_index {ci} "
                     f"window {window} ({dtype})")
            for dev_ci in (torch.tensor(ci, dtype=torch.int32, device=dev),
                           torch.full((b,), ci, dtype=torch.int32,
                                      device=dev)):
                at_dev = decode_attention_fwd(q, ck, cv, dev_ci,
                                              window=window)
                if not torch.equal(at_dev, out):
                    fail(f"decode kernel at a device cache_index "
                         f"{tuple(dev_ci.shape)} differs from the host-int "
                         f"launch at {ci} window {window} ({dtype})")
            if dtype == torch.bfloat16 and (ci, window) == (T - 1, None):
                main_err = err
        log(f"[check] decode {str(dtype)[6:]} ({decode_route(dtype)} "
            f"kernel) [4,32,128] over [4,640,8,128], "
            f"{splits} splits of {-(-T // splits)} positions: max_abs_err at "
            f"cache_index/window " + ", ".join(line) + f" (tol {tol}); "
            f"bitwise repeat; at a device cache_index (one, and one a row) "
            f"bit for bit the host-int launch")
        c = -(-T // splits)
        rows = [5, c - 1, c + 10, T - 1]
        line = [f"{w}: {decode_rows_check(q, ck, cv, rows, w, tol, dtype):.3e}"
                for w in (None, 20, 128)]
        log(f"[check] decode {str(dtype)[6:]} at distinct per-row device "
            f"indices {rows} (window " + ", ".join(line) + f"; tol {tol}): "
            f"each row bit for bit the host-int launch at its index, also "
            f"from a graph replayed at the indices reversed in place")
        # replayed from a CUDA graph after the index changed in place
        for window in (None, 128):
            ci_dev = torch.tensor(0, dtype=torch.int32, device=dev)
            decode_attention_fwd(q, ck, cv, ci_dev, window=window)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = decode_attention_fwd(q, ck, cv, ci_dev, window=window)
            for ci, _ in edges:
                ci_dev.fill_(ci)
                graph.replay()
                torch.cuda.synchronize()
                if not torch.equal(out, decode_attention_fwd(
                        q, ck, cv, ci, window=window)):
                    fail(f"decode graph replayed at cache_index {ci} "
                         f"window {window} differs from the host-int "
                         f"launch ({dtype})")
            del graph
        log(f"[check] decode {str(dtype)[6:]}: a CUDA graph of the launch at "
            f"a device cache_index, replayed after the index changed in "
            f"place to each of {[ci for ci, _ in edges]} (window None and "
            f"128), bit for bit the host-int launch")
    # the draft model's shape in phase_generate_family (c): head_dim 64,
    # the rows' cursors apart
    b, T, d = 4, 581, 64
    q = torch.randn(b, h, d, generator=gen, device=dev).to(torch.bfloat16)
    ck, cv = (torch.randn(b, T, kv, d, generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    rows = [131, 262, 400, 579]
    err = decode_rows_check(q, ck, cv, rows, None, TOL_BF16, "draft d 64")
    log(f"[check] decode bf16 at the draft's shape q [4,32,64] over "
        f"[4,581,8,64], per-row device indices {rows}: max_abs_err "
        f"{err:.3e} (tol {TOL_BF16}); each row bit for bit the host-int "
        f"launch, also from a graph replayed at the indices reversed")
    return main_err


def phase_kernel_times(gen, dev, card):
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_fwd_plain, decode_splits)
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_plain)
    rows = {}

    # flash at the prefill shape, then at the training shape; beside the
    # kernel of the main path (wgmma), the CUDA-core kernel it replaced
    # (simt) on the same inputs, timed in this run
    for key, (b, s, h, kv, d) in (("flash", (4, 512, 32, 8, 128)),
                                  ("flash_train", (2, 2048, 32, 8, 128))):
        el = 2
        call_bytes = (el * (2 * b * s * h * d + 2 * b * s * kv * d)
                      + 4 * b * h * s)
        n = copies_for(call_bytes)
        sets = [flash_inputs(gen, dev, b, s, h, kv, d) for _ in range(n)]
        lib_sets = [tuple(t.transpose(1, 2)
                          .repeat_interleave(h // t.shape[2], 1)
                          .contiguous() for t in qkv) for qkv in sets]
        ms = cuda_ms(lambda i: flash_attention_fwd(*sets[i % n],
                                                   causal=True), iters=40)
        simt_ms = cuda_ms(lambda i: _simt_fwd(*sets[i % n]), iters=5)
        plain_ms = cuda_ms(lambda i: flash_attention_fwd_plain(
            *sets[i % n], causal=True), iters=5)
        lib_ms = cuda_ms(lambda i: TF.scaled_dot_product_attention(
            *lib_sets[i % n], is_causal=True), iters=40)
        pairs = b * h * s * (s + 1) // 2        # causal (row, key) pairs
        bound_ms, bound_by = bound(call_bytes, 4 * d * pairs)
        rows[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         simt_ms=simt_ms,
                         shape=f"q {[b, s, h, d]} kv {[b, s, kv, d]}")
        del sets, lib_sets
    el = 2

    # decode at the largest cache index: the slice's cache, and one row
    # over a long cache (one block per (row, kv head) gave 8 blocks there)
    for key, (b, T, h, kv, d) in (("decode", (4, 640, 32, 8, 128)),
                                  ("decode_long", (1, 8192, 32, 8, 128))):
        ci = T - 1
        valid = ci + 1
        call_bytes = el * (2 * b * h * d + 2 * b * valid * kv * d)
        n = copies_for(call_bytes)
        sets = []
        for _ in range(n):
            q = torch.randn(b, h, d, generator=gen, device=dev)
            ck = torch.randn(b, T, kv, d, generator=gen, device=dev)
            cv = torch.randn(b, T, kv, d, generator=gen, device=dev)
            sets.append(tuple(t.to(torch.bfloat16) for t in (q, ck, cv)))
        lib_sets = [(q[:, :, None],
                     ck[:, :valid].transpose(1, 2)
                     .repeat_interleave(h // kv, 1).contiguous(),
                     cv[:, :valid].transpose(1, 2)
                     .repeat_interleave(h // kv, 1).contiguous())
                    for q, ck, cv in sets]
        # device time from a CUDA graph of back-to-back calls: the
        # wrapper's host time per call is longer than these kernels. The
        # main path launches at a device cache_index (read by the kernel
        # on the device); the host-int launch is timed beside it
        ci_dev = torch.tensor(ci, dtype=torch.int32, device=dev)
        ms = graph_ms(lambda i: decode_attention_fwd(*sets[i % n], ci_dev),
                      calls=60)
        host_ms = graph_ms(lambda i: decode_attention_fwd(*sets[i % n], ci),
                           calls=60)
        eager_ms = cuda_ms(lambda i: decode_attention_fwd(*sets[i % n], ci),
                           iters=200)
        plain_ms = graph_ms(lambda i: decode_attention_fwd_plain(
            *sets[i % n], ci), calls=10)
        lib_ms = graph_ms(lambda i: TF.scaled_dot_product_attention(
            *lib_sets[i % n]), calls=60)
        bound_ms, bound_by = bound(call_bytes, 4 * d * valid * h * b)
        rows[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         shape=f"q {[b, h, d]} cache {[b, T, kv, d]} "
                               f"cache_index {ci} on the device (CUDA "
                               f"graph; at a host-int index "
                               f"{host_ms:.4f} ms; kernel {eager_ms:.4f} ms "
                               f"a call eager)")
        # the split rule against half and twice its split count, same
        # inputs, same timing
        rule = decode_splits(
            T, b * kv, torch.cuda.get_device_properties(0)
            .multi_processor_count)
        alt = {}
        for k in sorted({max(1, rule // 2), rule, min(64, 2 * rule)}):
            alt[k] = graph_ms(
                lambda i: _decode_splits_at(*sets[i % n], ci, k), calls=60)
        log(f"[time] decode split count, {key} shape, cache_index {ci}: "
            + ", ".join(f"{k} splits{' (rule)' if k == rule else ''} "
                        f"{v:.4f} ms" for k, v in alt.items())
            + f" [{card}]")
        del sets, lib_sets
    for name, r in rows.items():
        old = (f", simt kernel {r['simt_ms']:.4f} ms" if "simt_ms" in r
               else "")
        log(f"[time] {name} {r.get('shape', '')}: kernel {r['ms']:.4f} ms"
            f"{old}, plain {r['plain_ms']:.4f} ms, sdpa "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) [{card}]")
    return rows


def paged_case(gen, dev, lens, T=1, dtype=torch.bfloat16, R=16, h=32,
               kvh=8, d=128, B=16, M=64, P=1025):
    """q, pools and int32 tables / seq_lens on the card: each row's table
    a random permutation of physical blocks (never block 0), rows 1 and 2
    sharing row 0's first half as prefix sharing does, idle rows (len 0)
    an all-zero table."""
    shape = (R, T, h, d) if T > 1 else (R, h, d)
    q = torch.randn(*shape, generator=gen, device=dev).to(dtype)
    kp = torch.randn(P, B, kvh, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, B, kvh, d, generator=gen, device=dev).to(dtype)
    tables = torch.stack([torch.randperm(P - 1, generator=gen,
                                         device=dev)[:M] + 1
                          for _ in range(R)]).to(torch.int32)
    tables[1:3, :M // 2] = tables[0, :M // 2]
    lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    tables[lens == 0] = 0
    return q, kp, vp, tables.contiguous(), lens


def sdpa_inputs(sets, lens, T=1):
    """SDPA's yardstick inputs for ``paged_case`` sets: q as [R, h, T, d],
    each row's K/V gathered through its table and head-expanded to [R, h,
    M * B, d] (outside every timing; the port never calls SDPA), and the
    [R, 1, T, M * B] mask of the positions query t attends (<= seq_len +
    t). Returns (list of (q, k, v), mask)."""
    q0, kp0, _, tbl0, _ = sets[0]
    (R, M), (_, B, kvh, d), h = tbl0.shape, kp0.shape, q0.shape[-2]
    dev = q0.device
    kpos = torch.arange(M * B, device=dev)
    qpos = lens[:, None] + torch.arange(T, device=dev)[None, :]
    mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
    out = []
    for q, kp, vp, tbl, _ in sets:
        tb = tbl.long()
        ks = kp[tb].reshape(R, M * B, kvh, d).transpose(1, 2)
        vs = vp[tb].reshape(R, M * B, kvh, d).transpose(1, 2)
        out.append((q.reshape(R, T, h, d).transpose(1, 2).contiguous(),
                    ks.repeat_interleave(h // kvh, 1).contiguous(),
                    vs.repeat_interleave(h // kvh, 1).contiguous()))
    return out, mask


def ragged_lens(gen, dev, T, R=16, B=16, M=64):
    edge = [0, B - 1, B, M * B - T]
    rest = torch.randint(1, M * B - T, (R - len(edge),), generator=gen,
                         device=dev).tolist()
    return edge + rest


def phase_ragged_checks(gen, dev):
    """The ragged kernel against its plain version at the engine's
    geometry (R 16, h 32, kvh 8, d 128, B 16, M 64, P 1025), bf16 (mma)
    and fp32 (simt): 1, 2, 4, 5 and 9 queries per row (5: the speculative
    verify at k = 4, 20 query rows a kv head, the mma kernel's two-tile
    instance; 9: k = 8, 36 query rows, which the wrapper runs as two
    launches of 5 and 4 queries), no window and window 100, lens with
    idle rows, block edges and a row at M * B - T, rows 1 and 2 borrowing
    row 0's blocks; fp16 (mma) at 5 and 9 queries per row; one long row among short ones; every call
    on its route by count and repeated bit for bit. Then one call
    captured in a CUDA graph and replayed after seq_lens and tables
    changed in place. Returns the bf16 T = 1 no-window error."""
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        query_windows, ragged_paged_attention, ragged_paged_attention_plain,
        ragged_route)
    first = None
    B, M = PAGED["block_size"], PAGED["max_blocks_per_seq"]
    for dtype, tol, Ts in ((torch.bfloat16, TOL_BF16, (1, 2, 4, 5, 9)),
                           (torch.float16, TOL_FP16, (5, 9)),
                           (torch.float32, TOL_FP32, (1, 2, 4, 5))):
        route = ragged_route(dtype, 128)
        cases = [(T, window, ragged_lens(gen, dev, T)) for T in Ts
                 for window in (None, 100)]
        if 1 in Ts:
            cases.append((1, None, [M * B - 1] + [3] * 15))
        for T, window, lens in cases:
            args = paged_case(gen, dev, lens, T=T, dtype=dtype)
            fn = ragged_paged_attention
            before = dict(fn.launches_by_route)
            out = fn(*args, window=window)
            again = fn(*args, window=window)
            torch.cuda.synchronize()
            before[route] += 2 * len(query_windows(T, 4))
            if fn.launches_by_route != before:
                fail(f"ragged {dtype} T={T}: launches by route "
                     f"{fn.launches_by_route} != {before}")
            ref = ragged_paged_attention_plain(*args, window=window)
            err = max_err(out, ref)
            same = torch.equal(out, again)
            log(f"[check] ragged {str(dtype)[6:]} ({route}) T={T} window "
                f"{window} q {list(args[0].shape)} pools "
                f"{list(args[1].shape)} seq_lens {lens[:4]}+...: "
                f"max_abs_err {err:.3e} tol {tol}; bitwise repeat {same}")
            if not err <= tol:
                fail(f"ragged kernel disagrees with its plain version "
                     f"({dtype}, T={T}, window {window})")
            if not same:
                fail(f"ragged kernel does not repeat ({dtype}, T={T})")
            if first is None:
                first = err
    q, kp, vp, tbl, sl = paged_case(gen, dev, ragged_lens(gen, dev, 1))
    ragged_paged_attention(q, kp, vp, tbl, sl)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ragged_paged_attention(q, kp, vp, tbl, sl)
    for _ in range(2):
        _, _, _, tbl2, sl2 = paged_case(gen, dev, ragged_lens(gen, dev, 1))
        tbl.copy_(tbl2)
        sl.copy_(sl2)
        graph.replay()
        torch.cuda.synchronize()
        err = max_err(out, ragged_paged_attention_plain(q, kp, vp, tbl, sl))
        log(f"[check] ragged CUDA-graph replay after in-place seq_lens / "
            f"table change: max_abs_err {err:.3e} tol {TOL_BF16}")
        if not err <= TOL_BF16:
            fail("ragged kernel replayed from a CUDA graph disagrees")
    return first


def phase_paged_time(gen, dev, card):
    """The ragged and the grid paged kernels at the engine's shape: R 16
    single-query rows, seq_lens drawn from 64..1023, bf16, the same inputs
    rotated through copies larger than the L2, device time from a CUDA
    graph. Yardstick: one SDPA call over K/V pre-gathered and
    head-expanded to [R, h, M*B, d] with a boolean length mask (the gather
    outside the timing; the port never calls it). Then the ragged kernel's
    first design (simt) on the same inputs, and the mma kernel at half and
    twice its chunk; the grid kernel's variants and weak shapes
    (``grid_times``). Returns one row for each kernel."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels.paged_attention import (
        paged_attention, paged_attention_plain)
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain)
    R, h, kvh, d, B, M = 16, 32, 8, 128, 16, 64
    lens = torch.randint(64, 1024, (R,), generator=gen, device=dev)
    valid = int((lens + 1).sum())
    el = 2
    call_bytes = el * (2 * valid * kvh * d + 2 * R * h * d)
    n = copies_for(call_bytes)
    sets = [paged_case(gen, dev, lens) for _ in range(n)]
    lib_sets, mask = sdpa_inputs(sets, lens)
    lib_ms = cuda_ms(lambda i: TF.scaled_dot_product_attention(
        *lib_sets[i % n], attn_mask=mask), iters=200)
    bound_ms, bound_by = bound(call_bytes, 4 * d * valid * h)
    rows = {}
    for key, fn, plain in (
            ("ragged", ragged_paged_attention, ragged_paged_attention_plain),
            ("grid", paged_attention, paged_attention_plain)):
        ms = graph_ms(lambda i: fn(*sets[i % n]), calls=40)
        plain_ms = cuda_ms(lambda i: plain(*sets[i % n]), iters=20)
        log(f"[time] {key}: kernel {ms:.4f} ms (device time, CUDA graph), "
            f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}, {call_bytes / 1e6:.1f} MB of "
            f"valid K/V for seq_lens {sorted(lens.tolist())}) [{card}]")
        rows[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
    # the ragged kernel's first design (simt) on the same bf16 inputs, and
    # the mma kernel at half and twice its chunk: for the times beside the
    # kernel's only, outside every counted run
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as ra
    from paddle_tpu_torch.ops.kernels import sm_count
    chunk = ra.ragged_chunk_blocks(R, M, B, kvh, sm_count(sets[0][0]))
    simt_ms = graph_ms(lambda i: ra._launch("simt", *sets[i % n], None,
                                            None, 0), calls=40)
    sweep = {}
    for c in sorted({max(1, chunk // 2), chunk, min(M, 2 * chunk)}):
        sweep[c] = graph_ms(lambda i: ra._launch("mma", *sets[i % n], None,
                                                 None, c), calls=40)
    log(f"[time] ragged: the first port's simt kernel on the same inputs "
        f"{simt_ms:.4f} ms; mma at chunk of "
        + ", ".join(f"{c} blocks {t:.4f} ms" for c, t in sweep.items())
        + f" (the rule takes {chunk}) [{card}]")
    grid_times(gen, dev, card, sets, n, lens, rows["grid"]["ms"])
    return rows


def _grid_lines(label, sets, n, lens, M, card, rule_ms=None):
    """One ``[time] grid`` line for bf16 inputs ``sets`` (n copies, the
    rows' ``lens``, M table slots): the mma kernel by its rule (timed here
    unless ``rule_ms`` is given), with its chunks in clusters of 8 and 16,
    the PR 4 kernel (simt) and the ragged kernel on the same inputs, the
    bound, and how many (row, chunk) blocks are live. Outside every
    counted run."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import sm_count
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention
    q, kp = sets[0][0], sets[0][1]
    R, h, d = q.shape
    _, B, kvh, _ = kp.shape
    sms = sm_count(q)
    split = pa.grid_split(R, M, kvh, sms)
    if rule_ms is None:
        rule_ms = graph_ms(lambda i: pa.paged_attention(*sets[i % n]),
                           calls=40)
    clusters = {}
    for cl in (8, 16):
        sp = pa.grid_split(R, M, kvh, sms, cluster=cl)
        clusters[sp] = graph_ms(lambda i: pa._launch(
            "mma", *sets[i % n], None, None, sp), calls=40)
    simt_ms = graph_ms(lambda i: pa._launch("simt", *sets[i % n], None,
                                            None), calls=20)
    ragged_ms = graph_ms(lambda i: ragged_paged_attention(*sets[i % n]),
                         calls=40)
    valid = sum(int(x) + 1 for x in lens)
    bound_ms, bound_by = bound(2 * (2 * valid * kvh * d + 2 * R * h * d),
                               4 * d * valid * h)
    live = pa.grid_live_chunks(sets[0][4], M, split[0], split[1], B)
    log(f"[time] grid {label} q {list(q.shape)} pools {list(kp.shape)}: mma "
        f"{rule_ms:.4f} ms by the rule (chunks, slots a chunk, kv heads a "
        f"block) {split}, live (row, chunk) blocks {int(live.sum())} of "
        f"{live.numel()}; clusters "
        + ", ".join(f"{sp} {t:.4f} ms" for sp, t in clusters.items())
        + f"; the PR 4 kernel (simt) {simt_ms:.4f} ms, ragged {ragged_ms:.4f}"
        f" ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    return dict(ms=rule_ms, simt_ms=simt_ms, ragged_ms=ragged_ms,
                bound_ms=bound_ms, clusters=clusters)


def grid_times(gen, dev, card, sets, n, lens, rule_ms):
    """The grid kernel at the engine's shape (``sets``, timed by
    ``phase_paged_time``) beside its variants, then at two weak shapes:
    one row of 8192 positions (R 1, M 512: at most 8 chunks of 1024 in
    one cluster) and the tick's short rows (R 16, seq_lens 256..300: most
    chunks dead); last 16 idle rows (one position each): the launch's
    fixed cost."""
    M = PAGED["max_blocks_per_seq"]
    out = {"engine": _grid_lines("engine", sets, n, lens, M, card, rule_ms)}
    long_lens = [8191]
    long_sets = [paged_case(gen, dev, long_lens, R=1, M=512, P=513)
                 for _ in range(copies_for(2 * 2 * 8192 * 8 * 128))]
    out["long"] = _grid_lines("one long row", long_sets, len(long_sets),
                              long_lens, 512, card)
    del long_sets
    short_lens = torch.randint(256, 301, (16,), generator=gen,
                               device=dev).tolist()
    nb = copies_for(2 * 2 * sum(x + 1 for x in short_lens) * 8 * 128)
    short_sets = [paged_case(gen, dev, short_lens) for _ in range(nb)]
    out["short"] = _grid_lines("tick's short rows", short_sets, nb,
                               short_lens, M, card)
    del short_sets
    idle_lens = [0] * 16
    out["idle"] = _grid_lines("idle rows (the fixed cost)",
                              [paged_case(gen, dev, idle_lens)], 1,
                              idle_lens, M, card)
    return out


def phase_small_reference(dev):
    """fp32 Llama with head_dim 128 and 4 query heads per kv head: logits
    of a 128-token prefill (flash) and 4 decode steps (decode kernel) on
    the card against the same model on the CPU (plain versions)."""
    import paddle_tpu_torch as ptt
    cfg = ptt.llama_tiny(hidden_size=512, intermediate_size=1024,
                         num_attention_heads=4, num_key_value_heads=1,
                         vocab_size=1024, max_position_embeddings=512)
    cpu = ptt.LlamaForCausalLM(cfg, device="cpu",
                               generator=ptt.make_generator(1, "cpu"))
    gpu = ptt.LlamaForCausalLM(cfg, device=dev,
                               generator=ptt.make_generator(1, dev))
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (2, 132),
                        generator=ptt.make_generator(2, "cpu"))
    worst = 0.0
    with torch.inference_mode():
        caches = {m: m.init_kv_caches(2, 132) for m in (cpu, gpu)}
        steps = [(ids[:, :128], 0)] + [(ids[:, t:t + 1], t)
                                       for t in range(128, 132)]
        for chunk, ci in steps:
            ref, caches[cpu] = cpu(chunk, kv_caches=caches[cpu],
                                   cache_index=ci)
            got, caches[gpu] = gpu(chunk.to(dev), kv_caches=caches[gpu],
                                   cache_index=ci)
            if not torch.isfinite(got).all():
                fail("small model: non-finite logits on the card")
            worst = max(worst, max_err(got.cpu(), ref))
    log(f"[small] fp32 Llama d=128 prefill 128 + 4 decode steps, card vs "
        f"CPU: max_abs_err {worst:.3e} tol {TOL_SMALL_LOGITS}")
    if not worst <= TOL_SMALL_LOGITS:
        fail("small model: card logits disagree with the CPU reference")


def _weight_gb(model) -> float:
    return sum(t.numel() * t.element_size()
               for t in [*model.parameters(), *model.buffers()]) / 1e9


def _step_program(model, match, label):
    """The decode program the model keeps (its buffers and its captured
    step) whose cache key satisfies ``match``."""
    for key, prog in model._gen_exec_cache.programs.items():
        if match(key):
            return prog
    fail(f"{label}: no such decode program on the model")


def _graph_kernels(prog, label, want):
    """The kernels the program's captured step launches at each replay,
    read from the graph's nodes: each of ``want`` ({name fragment: n})
    must be there n times. Returns {fragment: n} and the node count."""
    if prog.step.graph is None:
        fail(f"{label}: the decode step was never captured")
    names, memory = graph_nodes(prog.step.graph.graph)
    got = {frag: sum(frag in n for n in names) for frag in want}
    if got != want:
        fail(f"{label}: the step graph holds {got}, want {want}")
    return got, len(names), memory


def _generate_run(ptt, pred, ids, new, want, label, dev, card):
    """Warm-up (the first decode step of a program runs eagerly and
    captures it into a CUDA graph), the prefill's own time (a generate of
    1 token), then the main path: one greedy generate of ``new`` tokens
    with every kernel's count set to 0 just before and read just after
    (it must equal ``want``): its decode steps are replays of the
    captured step, whose graph's nodes must hold each per-step kernel
    once a layer (decode, and quant a projection), and the counts must be
    those nodes times the replays. A second greedy call must give the
    same tokens; the greedy and a seeded sampled stream must be bit for
    bit the uncaptured step's (``eager_steps``), whose decode step is
    timed beside the graphed one."""
    from paddle_tpu_torch.generation import eager_steps
    b, prompt = ids.shape
    L = pred.model.config.num_hidden_layers
    vocab = pred.model.config.vocab_size
    greedy = ptt.GenerationConfig(max_new_tokens=new)
    one = ptt.GenerationConfig(max_new_tokens=1)
    pred.generate(ids, config=greedy)   # warm-up: captures the step
    pred.generate(ids, config=one)      # the prefill's own program
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.generate(ids, config=one)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats(dev)
    read = _reset_launches()
    t0 = time.perf_counter()
    out = pred.generate(ids, config=greedy)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = read()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"[{label}] launches in one generate: {launches} (want {want})")
    if launches != want:
        fail(f"{label}: kernel launches {launches} != {want}")
    routes = _check_routes(label, flash=want["flash"], decode=want["decode"],
                           quant=want["quant"])
    prog = _step_program(
        pred.model, lambda k: k[:4] == ("generate", b, prompt + new, False),
        label)
    per_step = {"decode_mma_kernel": L}
    if want["quant"]:
        per_step["qmm_mma"] = QUANT_PER_LAYER * L
    nodes, n_nodes, n_memory = _graph_kernels(prog, label, per_step)
    if launches["decode"] != nodes["decode_mma_kernel"] * (new - 1):
        fail(f"{label}: decode launches {launches['decode']} are not the "
             f"graph's {nodes['decode_mma_kernel']} a step x {new - 1}")
    log(f"[{label}] the decode step is one CUDA-graph replay: its graph "
        f"holds {n_nodes} kernel nodes ({nodes} a step) and {n_memory} "
        f"memcpy/memset nodes; {new - 1} steps = {new - 1} replays; graph "
        f"pool {prog.step.pool_bytes / 2**20:.1f} MiB, step buffers "
        f"{prog.nbytes / 2**20:.1f} MiB [{card}]")
    if tuple(out.shape) != (b, prompt + new):
        fail(f"{label}: generate returned shape {tuple(out.shape)}")
    if not torch.equal(out[:, :prompt], ids):
        fail(f"{label}: generate changed the prompt")
    if not ((out >= 0) & (out < vocab)).all():
        fail(f"{label}: generate returned ids outside the vocabulary")
    decode_ms = (total_ms - prefill_ms) / (new - 1)
    log(f"[{label}] prefill {prefill_ms:.1f} ms ({b} x {prompt} tokens + "
        f"first token), decode {decode_ms:.2f} ms/token step (graphed), "
        f"{b * new / (total_ms / 1e3):.1f} new tokens/s, generate "
        f"{total_ms:.1f} ms, peak memory {peak_gb:.2f} GB [{card}]")
    again = pred.generate(ids, config=greedy)
    if not torch.equal(again, out):
        fail(f"{label}: a second greedy generate gave other tokens")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with eager_steps():
        eager = pred.generate(ids, config=greedy)
    torch.cuda.synchronize()
    eager_ms = ((time.perf_counter() - t0) * 1e3 - prefill_ms) / (new - 1)
    if not torch.equal(eager, out):
        fail(f"{label}: the graphed greedy stream differs from the "
             f"uncaptured step's")
    sampled_cfg = ptt.GenerationConfig(max_new_tokens=new, do_sample=True,
                                       temperature=0.8, top_p=0.95)
    sampled = pred.generate(ids, config=sampled_cfg,
                            generator=ptt.make_generator(7, dev))
    with eager_steps():
        sampled_eager = pred.generate(ids, config=sampled_cfg,
                                      generator=ptt.make_generator(7, dev))
    ok = (tuple(sampled.shape) == (b, prompt + new)
          and bool(((sampled >= 0) & (sampled < vocab)).all())
          and torch.equal(sampled[:, :prompt], ids))
    if not ok:
        fail(f"{label}: sampled generate returned invalid ids")
    if not torch.equal(sampled, sampled_eager):
        fail(f"{label}: the graphed sampled stream differs from the "
             f"uncaptured step's")
    log(f"[{label}] second greedy generate: identical tokens; greedy and "
        f"seeded sampled (temperature 0.8, top_p 0.95; "
        f"{int((sampled[:, prompt:] != out[:, prompt:]).sum())} of "
        f"{b * new} tokens differ from greedy) streams bit for bit the "
        f"uncaptured step's; uncaptured decode step {eager_ms:.2f} ms "
        f"against {decode_ms:.2f} graphed [{card}]")
    return dict(out=out, prefill_ms=prefill_ms, decode_ms=decode_ms,
                eager_ms=eager_ms, peak_gb=peak_gb, launches=launches,
                routes=routes, pool_mib=prog.step.pool_bytes / 2**20)


def phase_slice(seed, dev, card):
    """Llama-3-8B in bf16 through ``Predictor.generate``. Returns the run's
    numbers (with the prompt ids, the weights' bytes and the prefill's
    last-position logits, for the quantized phases to compare with) and
    the model."""
    import paddle_tpu_torch as ptt
    cfg = ptt.llama3_8b()
    t0 = time.perf_counter()
    model = ptt.LlamaForCausalLM(cfg, device=dev,
                                 generator=ptt.make_generator(seed, dev))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[slice] Llama-3-8B (hidden {cfg.hidden_size}, layers "
        f"{cfg.num_hidden_layers}, heads {cfg.num_attention_heads}/"
        f"{cfg.num_key_value_heads}, ffn {cfg.intermediate_size}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}): {n_params / 1e9:.2f} B params, "
        f"random init on the card in {time.perf_counter() - t0:.1f} s")
    pred = ptt.Predictor(model, device=dev)
    b, prompt, new = 4, 512, 128
    ids = torch.randint(0, cfg.vocab_size, (b, prompt), device=dev,
                        generator=ptt.make_generator(seed + 1, dev))
    L = cfg.num_hidden_layers
    want = dict(NO_LAUNCHES, flash=L, decode=L * (new - 1))
    run = _generate_run(ptt, pred, ids, new, want, "slice", dev, card)
    profile_decode_step(ptt, pred, ids, run["decode_ms"], card, "bf16")
    run.update(ids=ids, new=new, weight_gb=_weight_gb(model),
               logits=pred.run(ids)[:, -1].float())
    return run, model


def _reset_launches():
    from paddle_tpu_torch.ops.kernels.decode_attention import \
        decode_attention_fwd
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
        flash_attention_with_lse, flash_attention_with_lse_bwd)
    from paddle_tpu_torch.ops.kernels.fused_adam import fused_adam
    from paddle_tpu_torch.ops.kernels.paged_attention import paged_attention
    from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention
    fns = {"flash": flash_attention_fwd, "decode": decode_attention_fwd,
           "ragged": ragged_paged_attention,
           "flash_bwd_dq": flash_attention_bwd_dq,
           "flash_bwd_dkv": flash_attention_bwd_dkv,
           "quant": quant_matmul, "grid": paged_attention,
           "fused_adamw": fused_adam,
           "flash_lse": flash_attention_with_lse,
           "flash_lse_bwd": flash_attention_with_lse_bwd}
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
    return lambda: {k: fn.launches for k, fn in fns.items()}


# the tensor-core route of each routed kernel, which bf16 and fp16 take
FAST_ROUTE = {"flash": "wgmma", "flash_bwd_dq": "wgmma",
              "flash_bwd_dkv": "wgmma", "decode": "mma", "quant": "mma",
              "ragged": "mma", "grid": "mma"}


def _routed():
    from paddle_tpu_torch.ops.kernels.decode_attention import \
        decode_attention_fwd
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    from paddle_tpu_torch.ops.kernels.paged_attention import paged_attention
    from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention
    return {"flash": flash_attention_fwd,
            "flash_bwd_dq": flash_attention_bwd_dq,
            "flash_bwd_dkv": flash_attention_bwd_dkv,
            "decode": decode_attention_fwd, "quant": quant_matmul,
            "ragged": ragged_paged_attention, "grid": paged_attention}


def _check_routes(label, **want_fast):
    """Since the last ``_reset_launches``: each named routed kernel
    (``flash``, ``flash_bwd_dq``, ``flash_bwd_dkv``, ``decode``, ``quant``,
    ``ragged``, ``grid``) launched
    ``n`` times on its tensor-core route (``FAST_ROUTE``) and never on the
    simt route. Returns the counts by route."""
    fns = _routed()
    got = {k: dict(fns[k].launches_by_route) for k in want_fast}
    want = {k: {FAST_ROUTE[k]: n, "simt": 0} for k, n in want_fast.items()}
    log(f"[{label}] launches by route: {got} (want {want})")
    if got != want:
        fail(f"{label}: launches by route {got} != {want}")
    return got


def _serve(eng, subs, late_after: int):
    """Submit ``subs`` (rid, ids, kw), the last ones only after
    ``late_after`` ticks so they are admitted mid-decode; run to the end.
    Returns (results, wall seconds, {rid: TTFT ms}, ragged launches seen
    inside prefills)."""
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention
    t_sub, ttft, in_prefill = {}, {}, [0]
    mark = {}

    def sink(rid, kind, **_):
        now = time.perf_counter()
        if kind == "engine_queue":
            t_sub[rid] = now
        elif kind == "slot_take":
            mark[rid] = ragged_paged_attention.launches
        elif kind == "prefill_done":
            ttft[rid] = (now - t_sub[rid]) * 1e3
            in_prefill[0] += ragged_paged_attention.launches - mark[rid]
    eng.trace_sink = sink
    eng.results.clear()
    eng.logprobs.clear()
    first = len(subs) // 2
    t0 = time.perf_counter()
    for rid, ids, kw in subs[:first]:
        eng.submit(rid, ids, **kw)
    for _ in range(late_after):
        eng.step()
    for rid, ids, kw in subs[first:]:
        eng.submit(rid, ids, **kw)
    out = eng.run()
    torch.cuda.synchronize()
    eng.trace_sink = None
    return out, time.perf_counter() - t0, ttft, in_prefill[0]


def _fill(eng, ids, n_new):
    """Submit one 256-token greedy request per slot and run the step that
    admits and prefills them all (and dispatches their first tick)."""
    for i in range(eng.R):
        eng.submit(f"p{i}", ids(256), max_new_tokens=n_new)
    eng.step()
    torch.cuda.synchronize()


def _timed_ticks(eng, ticks: int) -> float:
    """Mean host ms of ``ticks`` steady steps, closed by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / ticks


def graph_nodes(graph):
    """(kernel names, memory-copy and memset nodes) of a CUDA graph
    captured with ``keep_graph=True``, read through libcuda's graph
    calls: what each replay launches, whatever a profiler records."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")

    class KernelParams(ctypes.Structure):      # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                    ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    def check(rc, what):
        if rc:
            fail(f"{what} returned CUresult {rc}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)),
          "cuGraphGetNodes")
    names, memory = [], 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value in (1, 2):               # memcpy, memset
            memory += 1
        if kind.value != 0:                    # 0: a kernel node
            continue
        p = KernelParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                               ctypes.byref(p)),
              "cuGraphKernelNodeGetParams_v2")
        func = p.func
        if not func:
            f = ctypes.c_void_p()
            check(cu.cuKernelGetFunction(ctypes.byref(f),
                                         ctypes.c_void_p(p.kern)),
                  "cuKernelGetFunction")
            func = f.value
        name = ctypes.c_char_p()
        check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)),
              "cuFuncGetName")
        names.append(name.value.decode())
    return names, memory


class _TimedGraph:
    """A captured graph whose ``replay`` records the host's time in the
    call (the launch of the whole graph), in ms."""

    def __init__(self, graph):
        self.graph, self.ms = graph, []

    def replay(self):
        t0 = time.perf_counter()
        self.graph.replay()
        self.ms.append((time.perf_counter() - t0) * 1e3)


def profile_paged_tick(eng, ids, card, ticks: int = 16, label="paged",
                       expect=None, n_new=None):
    """Where a steady paged decode tick's time goes: 16 greedy requests
    decoding (no admission, no finish: ``n_new`` tokens each, by default
    enough for one token a tick), ``ticks`` ticks timed on the host clock,
    then the same number under torch.profiler split by kernel kind
    (ragged or grid attention: their kernels' names). Device busy share =
    device time over the unprofiled tick. ``expect`` maps a kernel-name
    part to the kernels each tick must show (on a graphed engine also one
    graph launch a tick): it fails otherwise. Returns the tick's ms
    unprofiled and under the profiler, its device busy ms and the
    categories' device ms per tick, or None without device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _fill(eng, ids, n_new or 3 * ticks + 4)
    w0 = eng._h_decode.stats()["sum"]
    steady = (True, "spec" if eng._spec_k else 1,
              os.environ.get("PADDLE_TPU_PAGED_ATTN", "ragged"))
    timed = None
    if steady in eng._graphs:
        step = eng._graphs[steady]
        g = step.graph
        timed = _TimedGraph(g.graph)
        step.graph = g._replace(graph=timed)
    tick_ms = _timed_ticks(eng, ticks)
    if timed is not None:
        step.graph = g
    replay_ms = sum(timed.ms) / max(len(timed.ms), 1) if timed else 0.0
    # a fused engine's histogram holds its drains' waits for the device:
    # the rest of a step is the host's own
    wait_ms = (eng._h_decode.stats()["sum"] - w0) / ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _timed_ticks(eng, ticks)
    cats = {"ragged_attention": 0.0, "grid_attention": 0.0, "gemm": 0.0,
            "quant_matmul": 0.0, "other": 0.0}
    n = replays = 0
    launch_us = 0.0
    seen = dict.fromkeys(expect or (), 0)
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            if "cudaGraphLaunch" in e.name:
                replays += 1
                launch_us += e.time_range.elapsed_us()
            continue
        if getattr(e, "is_user_annotation", False):
            continue
        n += 1
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name.lower()
        for part in seen:
            seen[part] += part in name
        cat = ("ragged_attention" if "ragged_" in name else
               "grid_attention" if "grid_" in name else
               "quant_matmul" if "qmm_" in name else
               "gemm" if any(w in name for w in ("gemm", "gemv", "xmma",
                                                 "cutlass", "nvjet"))
               else "other")
        cats[cat] += e.time_range.elapsed_us() / 1e3 / ticks
    eng.run()
    if not n:
        log(f"[profile] torch.profiler recorded no device events: {label} "
            f"tick busy share not measured")
        return None
    busy = sum(cats.values())
    log(f"[profile] {label} decode tick (16 active rows from seq_len 256): "
        f"unprofiled {tick_ms:.2f} ms, under the profiler {wall:.2f} ms, "
        f"device busy {busy:.3f} ms ({100 * busy / tick_ms:.1f} % of the "
        f"unprofiled tick), {n / ticks:.0f} device ops per tick, "
        f"{replays / ticks:.2f} graph launches per tick; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in cats.items())
        + f" [{card}]")
    # where the device idles under the profiler: gaps between consecutive
    # device ops, short ones (inside a replay or a launch burst) apart
    # from long ones (the device waiting for the host's next step)
    spans.sort()
    gaps = [b - a1 for (_, a1), (b, _) in zip(spans, spans[1:]) if b > a1]
    short = sum(g for g in gaps if g <= 100.0) / 1e3 / ticks
    long_ = sum(g for g in gaps if g > 100.0) / 1e3 / ticks
    check_ms = 0.0
    if eng._fused:
        # the per-dispatch check that the weights did not move
        t0 = time.perf_counter()
        for _ in range(100):
            eng._graphs.moved()
        check_ms = (time.perf_counter() - t0) * 10
    log(f"[profile] {label} idle per tick under the profiler: gaps <= 100 "
        f"us between device ops {short:.3f} ms, longer gaps {long_:.3f} "
        f"ms; unprofiled: the drains' wait for the device {wait_ms:.3f} "
        f"ms a step, the host's own step {tick_ms - wait_ms:.3f} ms"
        + (f", of it the replay call {replay_ms:.3f} ms (under the "
           f"profiler its cudaGraphLaunch "
           f"{launch_us / 1e3 / max(replays, 1):.3f} ms) and the weights' "
           f"check {check_ms:.3f} ms"
           if eng._fused else " (host tick: the wait is its read-back)")
        + f" [{card}]")
    if expect:
        # the steady tick's graph: each named kernel ``expect`` times in
        # its node list; the profiler must see them in every replay,
        # short only by the device events it dropped in all (it drops a
        # few in long sessions): the replay's nodes and the ring's copies
        # a step, less what it recorded
        names, memory = graph_nodes(eng._graphs[steady].graph.graph)
        nodes = {k: sum(k in x.lower() for x in names) for k in expect}
        dropped = max((len(names) + memory + len(eng._ring_host)) * ticks
                      - n, 0)
        log(f"[profile] {label}: the steady graph holds {len(names)} "
            f"kernel and {memory} copy/memset nodes, by name {nodes}; "
            f"profiled kernels per tick by name "
            f"{ {k: v / ticks for k, v in seen.items()} } (want {expect}; "
            f"device events the profiler dropped: {dropped}), graph "
            f"launches per tick {replays / ticks:.2f}")
        if nodes != expect:
            fail(f"{label}: the tick graph's kernels by name {nodes} != "
                 f"{expect}")
        for k, want in expect.items():
            if not want * ticks - dropped <= seen[k] <= want * ticks:
                fail(f"{label}: {seen[k]} {k} kernels profiled in {ticks} "
                     f"ticks, want {want * ticks} less at most {dropped} "
                     f"dropped")
        if replays != ticks:
            fail(f"{label}: {replays} graph launches in {ticks} ticks")
    return dict(tick_ms=tick_ms, profiled_ms=wall, busy_ms=busy, cats=cats)


def tick_ab(fused, host, ids, card, label, ticks: int = 16,
            names=("fused", "host"), n_new=None):
    """The steady tick of two engines (by default the graphed default
    engine against the host tick), in turns (first, second, second,
    first) in this process, so the host's drift falls on both alike.
    ``n_new``: tokens a request, by default enough for one a tick."""
    a, b = names
    got = {a: [], b: []}
    for key in (a, b, b, a):
        eng = fused if key == a else host
        _fill(eng, ids, n_new or ticks + 8)
        got[key].append(_timed_ticks(eng, ticks))
        eng.run()
    mean = {k: sum(v) / len(v) for k, v in got.items()}
    log(f"[{label}] steady tick (16 rows from seq_len 256), ms in turns "
        f"{a}, {b}, {b}, {a}: {a} "
        + ", ".join(f"{x:.2f}" for x in got[a]) + f"; {b} "
        + ", ".join(f"{x:.2f}" for x in got[b])
        + f"; {b} / {a} {mean[b] / mean[a]:.2f} [{card}]")
    return mean


def _same_streams(label, out, lps, ref, ref_lps):
    """Tokens and logprobs of two runs bit for bit, or fail."""
    bad = sorted(r for r in ref if out.get(r) != ref[r]
                 or lps.get(r) != ref_lps.get(r))
    if bad or set(out) != set(ref):
        fail(f"{label}: the streams of two runs that must be bit for bit "
             f"equal differ: {bad}")


def phase_paged(seed, dev, card, model):
    """Llama-3-8B served by the ported PagedEngine at its defaults (the
    graphed device-resident tick) against its host tick."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.generation.paged import PagedEngine
    cfg = model.config
    L = cfg.num_hidden_layers
    rs = np.random.RandomState(seed + 10)
    gen = ptt.make_generator(seed + 11, "cpu")

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen)

    # (a) whole-prompt prefill, mixed traffic, admission mid-decode
    subs = []
    for i in range(24):
        kw = dict(max_new_tokens=int(rs.randint(32, 129)))
        if i % 6 == 5:
            kw.update(temperature=0.8, top_p=0.95, seed=1000 + i)
        if i == 3:
            kw["stop_sequences"] = [[int(t) for t in rs.randint(
                0, cfg.vocab_size, 2)], [int(rs.randint(cfg.vocab_size))]]
        subs.append((f"a{i}", ids(int(rs.randint(32, 769))), kw))
    eng = PagedEngine(model, **PAGED)
    host = PagedEngine(model, fused_tick=False, **PAGED)
    pool_gb = sum(kp.numel() * kp.element_size() * 2
                  for kp, _ in eng.pools) / 1e9
    log(f"[paged] PagedEngine({PAGED}) at its defaults (fused_tick, ring, "
        f"delta transitions, patch queue {eng._pq_len}, ring "
        f"{eng._ring_len}): KV pool {pool_gb:.2f} GB on the card, and "
        f"the same with fused_tick=False")
    # warm-up: the allocator, and the greedy and sampled graphs' captures
    _serve(eng, subs[:1], late_after=0)
    _serve(eng, subs[5:6], late_after=0)
    log(f"[paged] captured tick programs {sorted(eng._graphs)}: graph pool "
        f"{eng.graph_pool_bytes / 1e6:.1f} MB")
    torch.cuda.reset_peak_memory_stats(dev)
    steps0 = eng.stats["decode_steps"]
    disp0, up0 = eng.dispatch_count, eng.h2d_uploads
    read = _reset_launches()
    out, wall, ttft, in_prefill = _serve(eng, subs, late_after=8)
    launches = read()
    lps = dict(eng.logprobs)
    ticks = eng.stats["decode_steps"] - steps0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want = dict(NO_LAUNCHES, ragged=L * ticks)
    log(f"[paged] (a) launches in the run: {launches} (want {want}; "
        f"{in_prefill} inside prefills); {eng.dispatch_count - disp0} "
        f"dispatches and {eng.h2d_uploads - up0} uploads for {ticks} ticks "
        f"and {len(subs)} prefills; ring drains {eng.ring_drains}, "
        f"blocking {eng.ring_blocking_drains}; full rebuilds "
        f"{eng.full_rebuilds}, patches fused {eng.patches_fused}")
    if launches != want or in_prefill:
        fail(f"paged launches {launches} != {want} (prefills: "
             f"{in_prefill})")
    routes = _check_routes("paged (a)", ragged=L * ticks)
    if eng.dispatch_count - disp0 != ticks + len(subs):
        fail(f"paged (a): {eng.dispatch_count - disp0} dispatches for "
             f"{ticks} ticks and {len(subs)} prefills")
    new_tokens = 0
    for rid, tok_ids, kw in subs:
        got = out.get(rid)
        if got is None:
            fail(f"request {rid} did not finish")
        new_tokens += len(got)
        n = kw["max_new_tokens"]
        stopped = "stop_sequences" in kw and len(got) < n
        if len(got) != n and not stopped:
            fail(f"request {rid}: {len(got)} tokens, want {n}")
        if not all(0 <= t < cfg.vocab_size for t in got):
            fail(f"request {rid}: ids outside the vocabulary")
    h = eng._h_decode.stats()
    t = np.array([ttft[r] for r, _, _ in subs])
    log(f"[paged] (a) 24 requests, {new_tokens} new tokens in {ticks} "
        f"decode ticks, {wall:.2f} s: TTFT median {np.median(t):.1f} ms "
        f"p99 {np.percentile(t, 99):.1f} ms, mean drain wait "
        f"{h['mean']:.2f} ms (paged_decode_step_ms, {h['count']} drains "
        f"incl. warm-up), {new_tokens / wall:.1f} new tokens/s, peak "
        f"memory {peak_gb:.2f} GB, graph pool "
        f"{eng.graph_pool_bytes / 1e6:.1f} MB [{card}]")
    ref, hwall, httft, _ = _serve(host, subs, late_after=8)
    _same_streams("paged (a)", out, lps, ref, dict(host.logprobs))
    ht = np.array([httft[r] for r, _, _ in subs])
    log(f"[paged] (a) the host tick (fused_tick=False) on the same "
        f"submissions: identical tokens and logprobs (4 sampled "
        f"included), {hwall:.2f} s, {new_tokens / hwall:.1f} new tokens/s, "
        f"TTFT median {np.median(ht):.1f} ms p99 "
        f"{np.percentile(ht, 99):.1f} ms [{card}]")
    again, _, _, _ = _serve(eng, subs, late_after=8)
    if again != out:
        bad = [r for r in out if again.get(r) != out[r]]
        fail(f"a rerun of the same submissions gave other tokens: {bad}")
    log("[paged] (a) rerun of the same submissions: identical tokens "
        "(4 sampled included)")
    profile_paged_tick(eng, ids, card, expect={"ragged_": L})
    tick_ab(eng, host, ids, card, "paged")
    del eng, host

    # (b) chunked prefill + prefix cache
    eng = PagedEngine(model, chunk_prefill_tokens=128,
                      enable_prefix_cache=True, **PAGED)
    prefix = ids(512)
    subs = [(f"b{i}", torch.cat([prefix, ids(64)]),
             dict(max_new_tokens=32)) for i in range(8)]
    cold, _, _, _ = _serve(eng, subs[:1], late_after=0)
    warm, wall, ttft, _ = _serve(eng, subs[1:], late_after=2)
    hits = eng.stats["prefix_hit_tokens"]
    rid, tok_ids, kw = subs[0]
    res, _, _, _ = _serve(eng, [(rid, tok_ids, kw)], late_after=0)
    log(f"[paged] (b) chunk 128 + prefix cache: prefix_hit_tokens {hits}, "
        f"prefill chunks {eng.stats['prefill_chunks']}, 7 borrowers TTFT "
        f"median {np.median(list(ttft.values())):.1f} ms; resubmitted "
        f"prompt identical to its cold run: {res[rid] == cold[rid]}; "
        f"patches fused {eng.patches_fused}, full rebuilds "
        f"{eng.full_rebuilds} [{card}]")
    if not hits > 0:
        fail("the shared 512-token prefix never hit the prefix cache")
    if res[rid] != cold[rid] or any(len(v) != 32 for v in warm.values()):
        fail("a prefix-cache hit changed a request's greedy tokens")
    del eng

    # (c) preemption through Predictor.serve_stream, at the defaults
    pred = ptt.Predictor(model, device=dev)
    reqs = {f"c{i}": ids(256) for i in range(8)}
    geo = dict(PAGED, num_blocks=129)
    t0 = time.perf_counter()
    res = pred.serve_stream(reqs, max_new_tokens=128, **geo)
    wall = time.perf_counter() - t0
    st = pred.last_serve_stats
    log(f"[paged] (c) serve_stream, 8 x (256 + 128) tokens in a "
        f"{geo['num_blocks'] - 1}-block pool: preemptions "
        f"{st['preemptions']}, {st['decode_steps']} ticks, {wall:.2f} s "
        f"[{card}]")
    if not st["preemptions"] > 0:
        fail("the undersized pool never preempted")
    if sorted(res) != sorted(reqs) or any(len(v) != 128
                                          for v in res.values()):
        fail("serve_stream under preemption lost or cut a request")
    pred._paged_engines.clear()
    return launches, routes


def _teacher_gap(model, prompt, stream) -> float:
    """Re-score ``stream`` with one prefill forward over prompt + stream:
    the largest gap between a position's maximum logit and the logit of
    the token the engine emitted there (0 where it took the argmax)."""
    ids = torch.as_tensor(list(prompt) + list(stream[:-1]),
                          device=model.device)[None]
    with torch.inference_mode():
        logits = model(ids)[0, len(prompt) - 1:].float()
    tok = torch.as_tensor(stream, device=logits.device)[:, None]
    gap = logits.max(dim=-1).values - logits.gather(1, tok)[:, 0]
    return float(gap.max())


def _divergence(model, prompt, a, b):
    """Where two greedy streams of one prompt first differ: (index, the
    top-2 margin of the prefill re-score's logits there, the gaps of a's
    and b's tokens below that position's maximum). The re-score is one
    prefill over prompt + the common prefix."""
    i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
    ids = torch.as_tensor(list(prompt) + list(a[:i]),
                          device=model.device)[None]
    with torch.inference_mode():
        row = model(ids)[0, -1].float()
    top = row.topk(2).values
    return (i, float(top[0] - top[1]), float(top[0] - row[a[i]]),
            float(top[0] - row[b[i]]))


def _spec_stub_check(dev, card):
    """(d) The JAX tests' LookupStub on the card (logits read from a
    table, joined by the attention with weight 0.0; head_dim 128 in bf16,
    so each verify runs the ragged kernel at T = 5): the spec engine's
    streams bit for bit the spec-off engine's, greedy and sampled, with
    drafts accepted."""
    import numpy as np

    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention

    # the stub's one definition, in the GPU tests (no JAX there)
    LookupStub = _tests_module("test_torch_spec_gpu").LookupStub

    def cyc(n, start):
        return np.asarray([[(start + i) % 7 for i in range(n)]])

    sampled = dict(temperature=0.9, top_k=12, seed=3)
    subs = [("g0", cyc(6, 1), dict(max_new_tokens=30)),
            ("g1", cyc(9, 3), dict(max_new_tokens=25, eos_token_id=5)),
            ("s0", cyc(5, 2), dict(max_new_tokens=18, **sampled)),
            ("s1", cyc(8, 4), dict(max_new_tokens=24, temperature=1.5,
                                   top_p=0.9, seed=8))]
    geo = dict(max_slots=4, num_blocks=64, block_size=16,
               max_blocks_per_seq=8, prefill_buckets=(32,))
    runs = {}
    for k in (0, 4):
        eng = PagedEngine(LookupStub(device=dev, head_dim=128,
                                     dtype=torch.bfloat16),
                          spec_tokens=k, **geo)
        before = ragged_paged_attention.launches_by_route["mma"]
        for rid, ids, kw in subs:
            eng.submit(rid, ids, **kw)
        out = eng.run()
        runs[k] = (out, dict(eng.logprobs), eng.stats,
                   ragged_paged_attention.launches_by_route["mma"] - before,
                   sorted(eng._graphs))
    (off, off_lp, off_st, _, _), (on, on_lp, on_st, mma, graphs) = \
        runs[0], runs[4]
    log(f"[spec] (d) LookupStub (head_dim 128, bf16) on the card: spec "
        f"streams equal spec-off bit for bit (2 greedy, 2 sampled): "
        f"{on == off and on_lp == off_lp}; accepted "
        f"{on_st['spec_accepted']} of {on_st['spec_proposed']} drafts, "
        f"{on_st['decode_steps']} spec ticks against {off_st['decode_steps']}"
        f"; ragged mma launches {mma}; graphs {graphs} [{card}]")
    if on != off or on_lp != off_lp:
        fail("spec (d): the stub's spec streams differ from spec-off")
    if not on_st["spec_accepted"] > 0 or not mma > 0:
        fail("spec (d): the stub accepted no draft or never ran the ragged "
             "kernel")


def _spec_steady(eng, ids, L, card, ticks: int = 8):
    """(a) 16 rows each holding every block it needs, so no transition:
    each steady step must be one dispatch (one graph replay) and no
    upload, the replay counting 32 ragged launches a tick on the mma
    route, and the steady graph must hold 32 ragged kernel nodes."""
    _fill(eng, ids, 4 * eng._spec_k * ticks + 64)
    for _ in range(2):
        eng.step()
    for i in range(eng.R):
        eng._grow_blocks(i, eng._blocks_needed(
            int(eng.seq_lens[i]) + (eng._spec_k + 1) * (ticks + 3)))
    eng.step()                          # the growth's patches land
    torch.cuda.synchronize()
    d0, u0, t0 = eng.dispatch_count, eng.h2d_uploads, eng.stats[
        "decode_steps"]
    read = _reset_launches()
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    launches = read()
    n = eng.stats["decode_steps"] - t0
    names, memory = graph_nodes(eng._graphs[(
        True, "spec", os.environ.get("PADDLE_TPU_PAGED_ATTN",
                                     "ragged"))].graph.graph)
    rag = sum("ragged_" in x.lower() for x in names)
    log(f"[spec] (a) steady spec ticks: {n} ticks, "
        f"{eng.dispatch_count - d0} dispatches, "
        f"{eng.h2d_uploads - u0} uploads, launches {launches}; the steady "
        f"graph holds {len(names)} kernel nodes, {rag} of them ragged, and "
        f"{memory} copy/memset nodes [{card}]")
    if n != ticks or eng.dispatch_count - d0 != ticks \
            or eng.h2d_uploads != u0:
        fail("spec (a): a steady spec tick is not one dispatch without "
             "upload")
    if launches != dict(NO_LAUNCHES, ragged=L * ticks) or rag != L:
        fail(f"spec (a): ragged launches {launches} or graph nodes {rag} "
             f"!= {L} a tick")
    _check_routes("spec (a) steady", ragged=L * ticks)
    eng.close(drain=False)


def phase_spec(seed, dev, card, model):
    """Llama-3-8B served by ``PagedEngine(spec_tokens=4, spec_ngram=2)``
    at its other defaults (the speculative tick captured into a CUDA
    graph), against the spec-off default engine on the same submissions.
    Returns the ragged launches and routes of the spec run."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.generation.paged import PagedEngine
    t_phase = time.perf_counter()
    cfg = model.config
    L = cfg.num_hidden_layers
    rs = np.random.RandomState(seed + 20)
    gen = ptt.make_generator(seed + 21, "cpu")

    def pattern_ids(n):
        """n tokens repeating a seeded 64-token pattern."""
        pat = torch.randint(0, cfg.vocab_size, (64,), generator=gen)
        return pat.repeat(-(-n // 64))[:n]

    # 16 requests, each repeating its own pattern 2-5 times, 128 new
    # tokens: 12 greedy, 4 sampled
    subs = []
    for i in range(16):
        kw = dict(max_new_tokens=128)
        if i % 4 == 3:
            kw.update(temperature=0.8, top_p=0.9, seed=2000 + i)
        subs.append((f"s{i}", pattern_ids(64 * int(rs.randint(2, 6))), kw))
    eng = PagedEngine(model, **SPEC, **PAGED)
    off = PagedEngine(model, **PAGED)
    log(f"[spec] PagedEngine({SPEC}, {PAGED}) at its other defaults (ring "
        f"{eng._ring_len}, descriptor {eng._desc_len} int32), against "
        f"the spec-off default engine")
    # warm-up: the greedy and sampled spec graphs' captures (and the
    # spec-off engine's, for the tokens/s beside it)
    for e in (eng, off):
        _serve(e, subs[:1], late_after=0)
        _serve(e, subs[3:4], late_after=0)
    log(f"[spec] captured spec programs {sorted(eng._graphs)}: graph pool "
        f"{eng.graph_pool_bytes / 1e6:.1f} MB (spec-off engine "
        f"{off.graph_pool_bytes / 1e6:.1f} MB) [{card}]")
    steps0, off0 = eng.stats["decode_steps"], off.stats["decode_steps"]
    disp0, up0 = eng.dispatch_count, eng.h2d_uploads
    prop0, acc0 = eng.stats["spec_proposed"], eng.stats["spec_accepted"]
    _, tpf_sum0, tpf_n0 = eng._h_tpf.export()
    read = _reset_launches()
    out, wall, ttft, in_prefill = _serve(eng, subs, late_after=4)
    launches = read()
    ticks = eng.stats["decode_steps"] - steps0
    want = dict(NO_LAUNCHES, ragged=L * ticks)
    log(f"[spec] (a) launches in the run: {launches} (want {want}; "
        f"{in_prefill} inside prefills); {eng.dispatch_count - disp0} "
        f"dispatches and {eng.h2d_uploads - up0} uploads for {ticks} spec "
        f"ticks and {len(subs)} prefills")
    if launches != want or in_prefill:
        fail(f"spec launches {launches} != {want} (prefills: {in_prefill})")
    routes = _check_routes("spec (a)", ragged=L * ticks)
    if eng.dispatch_count - disp0 != ticks + len(subs):
        fail(f"spec (a): {eng.dispatch_count - disp0} dispatches for "
             f"{ticks} ticks and {len(subs)} prefills")
    for rid, _, kw in subs:
        got = out.get(rid)
        if got is None or len(got) != kw["max_new_tokens"] or not all(
                0 <= t < cfg.vocab_size for t in got):
            fail(f"spec request {rid}: {None if got is None else len(got)} "
                 f"tokens or ids outside the vocabulary")
    new_tokens = sum(len(v) for v in out.values())
    prop = eng.stats["spec_proposed"] - prop0
    acc = eng.stats["spec_accepted"] - acc0
    _, tpf_sum, tpf_n = eng._h_tpf.export()
    ref, owall, ottft, _ = _serve(off, subs, late_after=4)
    off_ticks = off.stats["decode_steps"] - off0
    t, ot = (np.array([d[r] for r, _, _ in subs]) for d in (ttft, ottft))
    log(f"[spec] 16 requests (12 greedy, 4 sampled), {new_tokens} new "
        f"tokens: spec {ticks} ticks, {wall:.2f} s, "
        f"{new_tokens / wall:.1f} new tokens/s, TTFT median "
        f"{np.median(t):.1f} ms; spec-off {owall:.2f} s, "
        f"{new_tokens / owall:.1f} new tokens/s, TTFT median "
        f"{np.median(ot):.1f} ms, {off_ticks} ticks; accept rate {acc / max(prop, 1):.4f} ({acc} of "
        f"{prop} drafts), tokens per forward a row "
        f"{(tpf_sum - tpf_sum0) / max(tpf_n - tpf_n0, 1):.3f} [{card}]")
    # (b) teacher-forced: each greedy stream re-scored by one prefill
    gaps = {}
    for name, res in (("spec", out), ("spec-off", ref)):
        gaps[name] = max(_teacher_gap(model, ids.tolist(), res[rid])
                         for rid, ids, kw in subs if "temperature" not in kw)
    same = {kind: sum(out[r] == ref[r] for r, _, kw in subs
                      if ("temperature" in kw) == (kind == "sampled"))
            for kind in ("greedy", "sampled")}
    log(f"[spec] (b) teacher-forced check of the 12 greedy streams (one "
        f"prefill over prompt + stream): largest gap between a position's "
        f"maximum logit and the emitted token's, spec {gaps['spec']:.4f}, "
        f"spec-off {gaps['spec-off']:.4f}, tolerance {TOL_TEACHER}; "
        f"streams identical between the engines: {same['greedy']} of 12 "
        f"greedy, {same['sampled']} of 4 sampled [{card}]")
    for rid, ids, kw in subs:
        if "temperature" in kw or out[rid] == ref[rid]:
            continue
        i, margin, ga, gb = _divergence(model, ids.tolist(), out[rid],
                                        ref[rid])
        log(f"[spec] (b) greedy stream {rid} first differs at token {i} "
            f"of {len(out[rid])}: top-2 margin there {margin:.4f} under "
            f"the prefill re-score; spec's token {ga:.4f} and spec-off's "
            f"{gb:.4f} below the maximum [{card}]")
    for name, g in gaps.items():
        if not g <= TOL_TEACHER:
            fail(f"spec (b): the {name} engine emitted a token {g:.4f} "
                 f"below its position's maximum logit")
    _spec_steady(eng, pattern_ids, L, card)
    prof = profile_paged_tick(eng, pattern_ids, card, label="spec",
                              expect={"ragged_": L}, n_new=5 * 2 * 16 + 16)
    if prof is not None:
        log(f"[spec] steady spec tick (16 rows from seq_len 256): "
            f"unprofiled {prof['tick_ms']:.2f} ms, profiled "
            f"{prof['profiled_ms']:.2f} ms, device busy "
            f"{prof['busy_ms']:.3f} ms "
            f"({100 * prof['busy_ms'] / prof['tick_ms']:.1f} %) [{card}]")
    tick_ab(eng, off, pattern_ids, card, "spec", names=("spec", "spec-off"),
            n_new=5 * 16 + 16)
    del eng, off
    _spec_stub_check(dev, card)
    log(f"[spec] the phase took {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return launches, routes


def _tests_module(name):
    """A module of the repository's ``tests`` directory (no JAX in it),
    loaded by its path: a ``tests`` package installed elsewhere may
    shadow ours."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timed_method(obj, name, sink):
    """Wrap ``obj.name`` so each call appends its ms to ``sink``, timed
    between two synchronizes of the card."""
    fn = getattr(obj, name)

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        sink.append((a, (time.perf_counter() - t0) * 1e3))
        return out
    setattr(obj, name, timed)


def _phase_split(eng, ticks, label, card):
    """The mean tick-phase split of ``eng``'s last ``ticks`` steady
    ticks (host, h2d, dispatch, device, drain and the wall, ms); fails
    unless each record's phases sum to its wall and the tickphase/1
    document validates."""
    from paddle_tpu_torch.utils import observability as obs
    doc = eng.tick_profile_doc()
    bad = obs.validate_tickphase_doc(doc)
    if bad:
        fail(f"{label}: the tickphase document is invalid: {bad[:3]}")
    recs = doc["entries"][-ticks:]
    for r in recs:
        gap = abs(sum(r[f"{p}_ms"] for p in obs.TICK_PHASES) - r["wall_ms"])
        if gap > 1e-3:
            fail(f"{label}: tick {r['tick']}'s phases miss its wall by "
                 f"{gap} ms")
    total = abs(sum(eng.tick_phase_totals.values()) - eng.tick_wall_ms_total)
    if total > 1e-6 * max(eng.tick_wall_ms_total, 1.0):
        fail(f"{label}: the phase totals miss the wall total by {total} ms")
    mean = {k: sum(r[f"{k}_ms"] for r in recs) / len(recs)
            for k in obs.TICK_PHASES + ("wall",)}
    log(f"[gateway] (b) {label}: mean of {len(recs)} steady ticks (16 rows "
        f"from seq_len 256), ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in mean.items())
        + f"; phases sum to the wall in every record (1e-3 ms), the "
        f"document validates [{card}]")
    if not all(r["dispatches"] == 1 for r in recs):
        fail(f"{label}: a steady profiled tick is not one dispatch")
    log(f"[gateway] (b) {label}: uploads in those ticks (block growth's "
        f"patches) {sum(r['uploads'] for r in recs)}, "
        f"{sum(r['bytes'] for r in recs)} B")
    return mean


def _gateway_traffic(rs, ids, new=(64, 128)):
    """The gateway's and the fleet's 24 requests: 16 share a 512-token
    prefix, prompts of 520-900 tokens, ``new`` (least, most) new tokens
    (the fleet's 64-128), every third one JSON (not streamed), one in six
    sampled. ``rs``: a numpy RandomState; ``ids(n)``: n seeded token
    ids."""
    prefix = ids(512)
    reqs = []
    for i in range(24):
        n_new = int(rs.randint(new[0], new[1] + 1))
        n_prompt = int(rs.randint(520, min(900, PAGED["max_blocks_per_seq"]
                                           * PAGED["block_size"] - n_new)
                                  + 1))
        prompt = prefix + ids(n_prompt - 512) if i < 16 else ids(n_prompt)
        r = dict(prompt=prompt, max_new_tokens=n_new, request_id=f"g{i}",
                 stream=i % 3 != 2)
        if i % 6 == 3:
            r.update(temperature=0.8, top_p=0.95, seed=3000 + i)
        reqs.append(r)
    return reqs


# the gateway's new tokens a request (least, most): cut from the fleet's
# 64-128 when [api] was added, to keep the script's time
GATEWAY_NEW = (32, 64)


def phase_gateway(seed, dev, card, model):
    """Llama-3-8B served over HTTP/SSE by the port's ``Gateway``: two
    replicas on the one model (graphed ticks, ring, tick profiler, prefix
    cache, a spill arena) against a direct engine; the tick-phase split
    of a plain and a speculative tick; ``/profilez``; the spill tier at
    full width; the drain. Returns the ragged launches and routes of the
    gateway's traffic, and the run dir holding its dumps (the reqtrace
    and tick-phase rings, the series docs, the span trace), which the
    [host] phase feeds to the report tools and then removes."""
    import asyncio

    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.serving import Gateway, KVSpillArena
    from paddle_tpu_torch.utils import observability as obs
    t_phase = time.perf_counter()
    client = _tests_module("test_torch_gateway_gpu")
    cfg = model.config
    L = cfg.num_hidden_layers
    route = os.environ.get("PADDLE_TPU_PAGED_ATTN", "ragged")
    rs = np.random.RandomState(seed + 30)
    gen = ptt.make_generator(seed + 31, "cpu")

    def tids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen)

    def ids(n):
        return tids(n).tolist()

    # the run dir /profilez traces into; the [host] phase reads its
    # artifacts and removes it
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_gateway_")
    obs.configure(run_dir)
    geo = dict(PAGED, chunk_prefill_tokens=128, enable_prefix_cache=True)
    reqs = _gateway_traffic(rs, ids, GATEWAY_NEW)
    arena = KVSpillArena(1 << 30, name="chip-gateway")
    engines = [PagedEngine(model, tick_profile=True, **geo)
               for _ in range(2)]
    # warm-up outside the gateway: each replica's greedy and sampled
    # tick graphs are captured before it takes traffic
    for eng in engines:
        eng.submit("w0", tids(200), max_new_tokens=4)
        eng.run()
        eng.submit("w1", tids(200), max_new_tokens=4, temperature=0.8,
                   seed=1)
        eng.run()
        eng.results.clear()
        eng.logprobs.clear()
    torch.cuda.synchronize()
    log(f"[gateway] two replicas PagedEngine({geo}, tick_profile=True) on "
        f"the one Llama-3-8B (their ticks serialize on the model's lock), "
        f"a 1 GiB KVSpillArena; graphs {[sorted(e._graphs) for e in engines]}")
    gw = Gateway(engines, name="chip", spill_arena=arena)
    ttft = {}
    steps0 = [e.stats["decode_steps"] for e in engines]
    out = {}

    async def one(r):
        t0 = time.perf_counter()

        async def first():
            ttft[r["request_id"]] = (time.perf_counter() - t0) * 1e3
        if r["stream"]:
            st, _, toks, fin = await client.sse(gw.port, r, on_first=first)
            return st, toks, fin
        st, _, payload = await client.http(
            gw.port, "POST", "/v1/generate", json.dumps(r).encode())
        fin = json.loads(payload)
        return st, fin.get("tokens"), fin

    async def serve():
        await gw.start()
        t0 = time.perf_counter()
        res = await asyncio.gather(*[one(r) for r in reqs])
        wall = time.perf_counter() - t0
        sizes = {}
        for path in ("/healthz", "/metrics", "/debugz"):
            st, _, body = await client.http(gw.port, "GET", path)
            if st != 200:
                fail(f"gateway {path}: status {st}")
            sizes[path] = body
        return res, wall, sizes

    async def profilez():
        """(c) 1 s of /profilez under load: 8 clients resend the first 8
        prompts until the capture answers (its start may take seconds:
        the first torch.profiler session of a process sets up CUPTI)."""
        stop, done = asyncio.Event(), []

        async def client_loop(k):
            i = 0
            while not stop.is_set():
                done.append(await one(dict(reqs[k], request_id=f"c{k}.{i}",
                                           stream=True)))
                i += 1
        load = [asyncio.ensure_future(client_loop(k)) for k in range(8)]
        await asyncio.sleep(0.2)
        st, _, body = await client.http(gw.port, "GET",
                                        "/profilez?duration_s=1")
        stop.set()
        await asyncio.gather(*load)
        return st, json.loads(body), done

    async def drain():
        """(e) drain() with 4 requests in flight, a fifth after it."""
        flights = [asyncio.ensure_future(one(dict(
            r, request_id=f"e{i}", stream=True, max_new_tokens=64)))
            for i, r in enumerate(reqs[16:20])]
        await client.poll(lambda: sum(e.health()["active_slots"]
                                      for e in engines) >= 4, 30)
        t0 = time.perf_counter()
        task = asyncio.ensure_future(gw.drain())
        await client.poll(lambda: gw.draining, 5)
        late = await client.sse(gw.port, dict(prompt=reqs[0]["prompt"],
                                              max_new_tokens=4))
        done = await asyncio.gather(*flights)
        await task
        return done, late, time.perf_counter() - t0

    async def main():
        read = _reset_launches()
        res, wall, sizes = await serve()
        launches = read()
        ticks = [e.stats["decode_steps"] - s0
                 for e, s0 in zip(engines, steps0)]
        routes = _check_routes("gateway (a)", ragged=L * sum(ticks))
        pz = await profilez()
        dr = await drain()
        return res, wall, sizes, launches, ticks, routes, pz, dr

    res, wall, sizes, launches, ticks, routes, pz, dr = asyncio.run(main())
    # the replicas' request-trace rings and tick-phase rings, kept in the
    # run dir for the report tools of the [host] phase
    dumped = gw.dump_traces(run_dir) + gw.dump_tick_profiles(run_dir)
    # (a) the streams against a direct engine over the same submissions
    for r, (st, toks, fin) in zip(reqs, res):
        if st != 200 or fin.get("finish_reason") != "stop":
            fail(f"gateway (a) {r['request_id']}: status {st}, {fin}")
        out[r["request_id"]] = (toks, fin["logprobs"])
    want = dict(NO_LAUNCHES, ragged=L * sum(ticks))
    log(f"[gateway] (a) launches in the run: {launches} (want {want}: "
        f"{L} x the {ticks} decode ticks of the two replicas, counted "
        f"inside the graphs)")
    if launches != want:
        fail(f"gateway (a): launches {launches} != {want}")
    for i, eng in enumerate(engines):
        step = eng._graphs[(True, 1, route)]
        names, _ = graph_nodes(step.graph.graph)
        rag = sum("ragged_" in x.lower() for x in names)
        if rag != L:
            fail(f"gateway (a): replica r{i}'s steady graph holds {rag} "
                 f"ragged kernels, not {L}")
    direct = PagedEngine(model, **geo)
    for r in reqs:
        kw = {k: v for k, v in r.items()
              if k not in ("prompt", "request_id", "stream")}
        direct.submit(r["request_id"], torch.as_tensor(r["prompt"]), **kw)
    ref = direct.run()
    bad = []
    for r in reqs:
        rid = r["request_id"]
        toks, lps = out[rid]
        if toks != ref[rid] or lps != direct.logprobs[rid]:
            bad.append(rid)
            if toks != ref[rid] and "temperature" not in r:
                i, margin, ga, gb = _divergence(model, r["prompt"], toks,
                                                ref[rid])
                log(f"[gateway] (a) stream {rid} first differs from the "
                    f"direct engine's at token {i} of {len(toks)}: top-2 "
                    f"margin there {margin:.4f} under a prefill re-score; "
                    f"the gateway's token {ga:.4f} and the direct "
                    f"engine's {gb:.4f} below the maximum [{card}]")
    hits = [e.stats["prefix_hit_tokens"] for e in engines]
    t = np.array([ttft[r["request_id"]] for r in reqs if r["stream"]])
    new_tokens = sum(len(out[r["request_id"]][0]) for r in reqs)
    log(f"[gateway] (a) 24 requests over HTTP (16 SSE, 8 JSON, 4 sampled; "
        f"16 share a 512-token prefix; prompts 520-900, "
        f"{GATEWAY_NEW[0]}-{GATEWAY_NEW[1]} new): "
        f"{new_tokens} new tokens in {wall:.2f} s, {new_tokens / wall:.1f} "
        f"new tokens/s; client TTFT (SSE) median {np.median(t):.1f} ms p99 "
        f"{np.percentile(t, 99):.1f} ms; decode ticks {ticks}; "
        f"prefix_hit_tokens by replica {hits}; streams bit for bit the "
        f"direct engine's: {24 - len(bad)} of 24 [{card}]")
    if bad:
        fail(f"gateway (a): streams differ from the direct engine's: {bad}")
    if not max(hits) > 0:
        fail("gateway (a): the shared prefix never hit a replica's cache")
    prom = sizes["/metrics"].decode()
    line = next(ln for ln in prom.splitlines()
                if ln.startswith("gateway_tokens_total{"))
    log(f"[gateway] (a) /healthz {len(sizes['/healthz'])} B, /metrics "
        f"{len(sizes['/metrics'])} B ({len(prom.splitlines())} lines; "
        f"{line}), /debugz {len(sizes['/debugz'])} B")
    # (c) /profilez
    st, body, done = pz
    if st != 200 or not body.get("traced") or not body.get("trace") \
            or not os.path.getsize(body["trace"]) > 0:
        fail(f"gateway (c): /profilez did not trace: {st} {body}")
    if any(s != 200 or f.get("finish_reason") != "stop"
           for s, _, f in done):
        fail("gateway (c): a request under the capture failed")
    with open(body["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    n_rag = sum("ragged_" in k.lower() for k in kernels)
    n_launch = sum("cudaGraphLaunch" in e.get("name", "") for e in events)
    if not n_rag:
        fail(f"gateway (c): the /profilez trace holds no ragged kernel "
             f"({len(kernels)} kernels, {n_launch} graph launches)")
    log(f"[gateway] (c) /profilez?duration_s=1 under 8 SSE clients "
        f"({len(done)} requests served meanwhile): traced, "
        f"{os.path.getsize(body['trace'])} B of Chrome trace with "
        f"{len(kernels)} kernels ({n_rag} ragged; the profiler may drop "
        f"some of a replayed graph's) and {n_launch} cudaGraphLaunch, "
        f"{len(body['tickphase_files'])} tickphase files; per replica "
        + "; ".join(f"{k}: {v['ticks_in_window']} ticks, wall "
                    f"{v['wall_ms_in_window']} ms, phases "
                    f"{v['phase_ms_in_window']}"
                    for k, v in body["replicas"].items())
        + f" [{card}]")
    # (e) the drain
    done, late, drain_s = dr
    held = [e.health() for e in engines]
    log(f"[gateway] (e) drain() with 4 requests in flight: they finished "
        f"{[f.get('finish_reason') for _, _, f in done]}, a request after "
        f"it got {late[0]}, slots held afterwards "
        f"{[h['active_slots'] for h in held]}, queued "
        f"{[h['queued'] for h in held]}; {drain_s:.2f} s, arena "
        f"{arena.snapshot()['records']} records after the drain's spill")
    if any(s != 200 or f.get("finish_reason") != "stop" or len(tk) != 64
           for s, tk, f in done) or late[0] != 503 \
            or any(h["active_slots"] or h["queued"] for h in held):
        fail("gateway (e): the drain lost a request, admitted one, or left "
             "a slot held")
    for eng in engines:
        obs.unregister_flusher(eng._flush_tick_profile)
    del gw, engines

    # (b) the tick-phase split of a steady plain and a steady spec tick
    on = PagedEngine(model, tick_profile=True, **PAGED)
    off = PagedEngine(model, **PAGED)
    _fill(on, tids, 64)
    for _ in range(16):
        on.step()
    torch.cuda.synchronize()
    _phase_split(on, 16, "plain tick, profile on", card)
    on.run()
    tick_ab(on, off, tids, card, "gateway (b) plain",
            names=("profile-on", "profile-off"))
    obs.unregister_flusher(on._flush_tick_profile)
    del on, off

    def pattern_ids(n):
        pat = tids(64)
        return pat.repeat(-(-n // 64))[:n]

    son = PagedEngine(model, tick_profile=True, **SPEC, **PAGED)
    soff = PagedEngine(model, **SPEC, **PAGED)
    _fill(son, pattern_ids, 5 * 16 + 32)
    for _ in range(12):
        son.step()
    torch.cuda.synchronize()
    _phase_split(son, 12, "spec tick (k 4), profile on", card)
    son.run()
    tick_ab(son, soff, pattern_ids, card, "gateway (b) spec",
            names=("profile-on", "profile-off"), n_new=5 * 16 + 16)
    obs.unregister_flusher(son._flush_tick_profile)
    del son, soff

    # (d) the spill tier at full width: a 128-block pool (2 MiB a block)
    # serving more prefixes than it holds
    spill_geo = dict(PAGED, num_blocks=129, chunk_prefill_tokens=128,
                     enable_prefix_cache=True)
    sarena = KVSpillArena(1 << 30, name="chip-spill")
    seng = PagedEngine(model, **spill_geo)
    seng.attach_spill(sarena)
    restores, chunks, takes = [], [], []
    _timed_method(seng, "_restore_span", restores)
    _timed_method(sarena, "take", takes)
    _timed_method(seng, "_advance_chunk", chunks)
    p1 = ids(512)
    a = p1 + ids(64)
    a2 = p1 + ids(64)
    seng.submit("a", torch.as_tensor(a), max_new_tokens=64)
    # the cold prompt's 5 chunks (4 of the prefix, the 64-token tail)
    # under torch.profiler: the card's busy time against the chunks' wall
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            seng.step()
        torch.cuda.synchronize()
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    cold = seng.run()["a"]
    prefill_ms = sum(ms for _, ms in chunks[:4])   # the prefix's 4 chunks
    log(f"[gateway] (d) cold prompt of 576 tokens as 5 prefill chunks of "
        f"128 (each step of a lone request: one chunk, then its first "
        f"tick): {[round(ms, 2) for _, ms in chunks[:5]]} ms a chunk "
        f"(synchronized); under the profiler the card was busy "
        f"{busy:.2f} ms over {len(dev_ev)} device ops in those 5 steps "
        f"[{card}]")
    for i in range(4):
        seng.submit(f"f{i}", torch.as_tensor(ids(512) + ids(64)),
                    max_new_tokens=64)
    seng.run()
    spans = seng.stats["spill_spans"]
    graphs = dict(seng._graphs)
    pool_bytes = seng.graph_pool_bytes
    b0 = seng.h2d_upload_bytes
    seng.submit("a2", torch.as_tensor(a2), max_new_tokens=64)
    got = seng.run()["a2"]
    got_lps = seng.logprobs["a2"]
    st = seng.stats
    warm = PagedEngine(model, **geo)
    warm.submit("a", torch.as_tensor(a), max_new_tokens=64)
    warm_a = warm.run()["a"]
    warm.submit("a2", torch.as_tensor(a2), max_new_tokens=64)
    warm_a2 = warm.run()["a2"]
    recaptured = seng._graphs.keys() != graphs.keys() or any(
        seng._graphs[k] is not g for k, g in graphs.items()) \
        or seng.graph_pool_bytes != pool_bytes
    rms = sum(ms for _, ms in restores)
    log(f"[gateway] (d) spill tier: PagedEngine(num_blocks=129, chunk 128, "
        f"prefix cache) + 1 GiB arena: {spans} spans spilled under the "
        f"flood; the 512-token prefix restored {st['spill_restores']} "
        f"time(s) ({st['spill_restored_tokens']} tokens, "
        f"{st['spill_restore_failures']} failures) in {rms:.2f} ms "
        f"(of it the arena's take, its crc32 check included, "
        f"{sum(ms for _, ms in takes):.2f} ms; {len(restores)} restore "
        f"calls, "
        f"{(seng.h2d_upload_bytes - b0) / 2 ** 20:.1f} MiB uploaded) "
        f"against {prefill_ms:.2f} ms for the prefix's 4 prefill chunks "
        f"cold; graphs recaptured across the restore: {recaptured}; the "
        f"restored stream equals the warm engine's: {got == warm_a2 and got_lps == warm.logprobs['a2']}; "
        f"the cold stream the warm engine's: {cold == warm_a} [{card}]")
    if not spans > 0 or not st["spill_restores"] > 0 \
            or st["spill_restore_failures"]:
        fail(f"gateway (d): spill {spans}, restores {st['spill_restores']}, "
             f"failures {st['spill_restore_failures']}")
    if got != warm_a2 or got_lps != warm.logprobs["a2"] or cold != warm_a:
        fail("gateway (d): the restored stream differs from the warm one")
    if recaptured:
        fail("gateway (d): a restore recaptured the tick graphs")
    del seng, warm, direct
    obs.reset()        # flushes the series docs and the span trace
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[gateway] dumps kept for the [host] phase's tools in {run_dir}: "
        f"{[os.path.basename(p) for p in dumped]} and "
        f"{sorted(os.listdir(run_dir))}")
    log(f"[gateway] the phase took {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return launches, routes, run_dir


def _write_safetensors(path, tensors):
    """The safetensors layout (an 8-byte little-endian header length, a
    JSON header, the raw little-endian tensors) of {name: CPU bf16
    tensor}, written without the ``safetensors`` package."""
    import struct
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.uint8).numpy().tobytes())


def _write_hf_llama(d, cfg, tensors) -> int:
    """A Llama's {name: CPU bf16 tensor} as an HF checkpoint in ``d``: two
    shards (the decoder layers, the rest) and an index, and a
    ``config.json`` of ``cfg``'s widths. Returns the bytes written."""
    shards = {n: ("model-00001-of-00002.safetensors"
                  if n.startswith("model.layers.")
                  else "model-00002-of-00002.safetensors")
              for n in sorted(tensors)}
    for shard in sorted(set(shards.values())):
        _write_safetensors(os.path.join(d, shard),
                           {n: tensors[n] for n in sorted(tensors)
                            if shards[n] == shard})
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": shards}, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_hidden_layers,
                   "num_attention_heads": cfg.num_attention_heads,
                   "num_key_value_heads": cfg.num_key_value_heads,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "rms_norm_eps": cfg.rms_norm_eps,
                   "rope_theta": cfg.rope_theta,
                   "tie_word_embeddings": False,
                   "torch_dtype": "bfloat16"}, f)
    return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))


# Llama-3.2-1B's published widths (its config.json): the draft model of
# the speculative check, with random weights from the seed
LLAMA32_1B = dict(vocab_size=128256, hidden_size=2048,
                  intermediate_size=8192, num_hidden_layers=16,
                  num_attention_heads=32, num_key_value_heads=8,
                  rope_theta=500000.0, tie_word_embeddings=True,
                  max_position_embeddings=131072,
                  rope_scaling={"rope_type": "llama3", "factor": 32.0,
                                "low_freq_factor": 1.0,
                                "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 8192})


def _family_beam(ptt, model, dev, card, gen):
    """(a) beam search, b 2, 4 beams, 64 new, length_penalty 1.2."""
    from paddle_tpu_torch.generation import eager_steps
    L, V = model.config.num_hidden_layers, model.config.vocab_size
    b, k, prompt, new = 2, 4, 512, 64
    ids = torch.randint(0, V, (b, prompt), device=dev, generator=gen)
    cfg = ptt.GenerationConfig(max_new_tokens=new, num_beams=k,
                               length_penalty=1.2)
    ptt.generate(model, ids, cfg)               # warm-up: captures
    read = _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ptt.generate(model, ids, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read()
    want = dict(NO_LAUNCHES, flash=L, decode=L * (new - 1))
    if launches != want:
        fail(f"beam: launches {launches} != {want}")
    _check_routes("beam", flash=L, decode=L * (new - 1))
    prog = _step_program(model, lambda key: key[:4] == (
        "beam", b, k, prompt + new), "beam")
    _graph_kernels(prog, "beam", {"decode_mma_kernel": L})
    with eager_steps():
        eager = ptt.generate(model, ids, cfg)
    if not torch.equal(out, eager):
        fail("beam: the graphed beam search differs from its uncaptured "
             "run")
    if tuple(out.shape) != (b, prompt + new) or \
            not torch.equal(out[:, :prompt], ids):
        fail("beam: wrong shape or prompt")
    log(f"[family] (a) beam search, b {b} x {k} beams ({b * k} decode "
        f"rows), {prompt} + {new} tokens, length_penalty 1.2: {ms:.1f} ms "
        f"({(ms / new):.2f} ms a step), launches {launches}; each step one "
        f"replay of a graph with {L} decode nodes (at {b * k} rows); the "
        f"output bit for bit its uncaptured run; graph pool "
        f"{prog.step.pool_bytes / 2**20:.1f} MiB [{card}]")


def _spec_line(label, stats, ms, card, extra=""):
    fwd = stats["target_forwards"]
    tpf = stats["tokens_per_forward"]
    log(f"[family] {label}: {ms:.1f} ms, target forwards by row {fwd} "
        f"(plain greedy: {sum(stats['emitted_tokens'])} in all), tokens "
        f"per forward {[round(x, 3) for x in tpf]} (mean "
        f"{sum(tpf) / len(tpf):.3f}){extra} [{card}]")


def _family_spec(ptt, model, dev, card, gen, seed):
    """(b) prompt-lookup (128 new) and (c) draft-model (64 new)
    speculative generate on 4 rows repeating a 64-token pattern, k 4."""
    from paddle_tpu_torch.generation import eager_steps
    from paddle_tpu_torch.generation.speculative import (
        ngram_speculative_generate, speculative_generate)
    L, V = model.config.num_hidden_layers, model.config.vocab_size
    b, prompt, new, k = 4, 512, 128, 4
    ids = torch.randint(0, V, (b, 64), device=dev,
                        generator=gen).repeat(1, prompt // 64)
    kw = dict(max_new_tokens=new, num_draft_tokens=k, return_stats=True)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def teacher(label, out):
        gaps = [_teacher_gap(model, out[r, :prompt].tolist(),
                             out[r, prompt:].tolist()) for r in range(b)]
        if max(gaps) > TOL_TEACHER:
            fail(f"{label}: a greedy stream's teacher-forced gap "
                 f"{max(gaps):.4f} exceeds {TOL_TEACHER}")
        return f"; teacher-forced gaps {[round(g, 4) for g in gaps]} " \
            f"(tol {TOL_TEACHER})"

    ngram = lambda **x: ngram_speculative_generate(  # noqa: E731
        model, ids, ngram=2, **kw, **x)
    ngram()                                     # warm-up: captures
    read = _reset_launches()
    (out, stats), ms = timed(ngram)
    launches = read()
    if launches != dict(NO_LAUNCHES, flash=L):
        fail(f"ngram: launches {launches} (the verify takes the masked "
             f"cache path: flash {L} for the prefill, nothing else)")
    prog = _step_program(model, lambda key: key[:3] == ("spec", id(None), 2)
                         and not key[-1], "ngram")
    _spec_line("(b) ngram_speculative_generate, greedy, ngram 2", stats, ms,
               card, teacher("ngram", out)
               + f"; {prog.last_steps} iterations, each one replay")
    skw = dict(temperature=0.8, top_p=0.95)
    ngram(generator=ptt.make_generator(seed + 42, dev), **skw)
    (sout, sstats), sms = timed(lambda: ngram(
        generator=ptt.make_generator(seed + 42, dev), **skw))
    with eager_steps():
        seager, _ = ngram(generator=ptt.make_generator(seed + 42, dev), **skw)
    if not torch.equal(sout, seager):
        fail("ngram sampled: the graphed stream differs from its "
             "uncaptured run")
    if not ((sout >= 0) & (sout < V)).all():
        fail("ngram sampled: ids outside the vocabulary")
    _spec_line("(b) ngram_speculative_generate, sampled (temperature 0.8, "
               "top_p 0.95)", sstats, sms, card,
               "; bit for bit its uncaptured run")

    draft = ptt.LlamaForCausalLM(ptt.LlamaConfig(**LLAMA32_1B), device=dev,
                                 generator=ptt.make_generator(seed + 43,
                                                              dev))
    DL = draft.config.num_hidden_layers
    # 64 new tokens, not 128: the phase's one cut, for the script's time
    kw = dict(kw, max_new_tokens=64)
    speculative_generate(model, draft, ids, **kw)          # warm-up
    read = _reset_launches()
    (dout, dstats), dms = timed(
        lambda: speculative_generate(model, draft, ids, **kw))
    launches = read()
    prog = _step_program(model, lambda key: key[:2] == ("spec", id(draft)),
                         "draft")
    want = dict(NO_LAUNCHES, flash=L + DL,
                decode=DL * (k + 1) * prog.last_steps)
    if launches != want:
        fail(f"draft: launches {launches} != {want}")
    _check_routes("draft", flash=L + DL, decode=want["decode"])
    _graph_kernels(prog, "draft", {"decode_mma_kernel": DL * (k + 1)})
    _spec_line(f"(c) speculative_generate, draft Llama-3.2-1B widths "
               f"(hidden 2048, {DL} layers, 32/8 heads, head_dim 64, ffn "
               f"8192, tied), random weights", dstats, dms, card,
               teacher("draft", dout)
               + f"; {prog.last_steps} iterations, each one replay of a "
                 f"graph with {DL * (k + 1)} decode nodes (the draft's, "
                 f"per-row cache index), launches {launches}")
    # the program in the target's cache holds the draft weakly: dropping
    # it frees its weights, and the program goes stale
    alive = weakref.ref(draft)
    del draft
    gc.collect()
    if alive() is not None:
        fail("draft: the dropped draft model is still alive")
    if not prog.stale():
        fail("draft: the program of a dropped draft is not stale")
    log("[family] (c) the dropped draft model is freed (the target's "
        "cached program held it weakly) and its program is stale")


def _batched(bp, prompts, engine, **kw):
    """``len(prompts)`` concurrent ``submit``s to ``bp``, its engine call
    set to ``engine(ids, **kw)`` (recording each batch): each answer must
    be bit for bit its row of the same stacked batch through ``engine``.
    Returns (batches formed, wall s, health, queue-wait histogram)."""
    import threading

    from paddle_tpu_torch.utils import observability as obs
    n = len(prompts)
    batches = []

    def record(ids):
        batches.append(ids.copy())
        return engine(ids, **kw)
    bp.predictor.run = record
    futs = [None] * n
    go = threading.Barrier(n)

    def client(i):
        go.wait(timeout=60)
        futs[i] = bp.submit(prompts[i])
    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    bp.close()
    h = bp.health()
    wait = obs.registry().snapshot()[
        f'serving_queue_wait_ms{{engine="{bp._obs_labels["engine"]}"}}']
    ref = {}
    for batch in batches:
        for row, ids in zip(engine(batch, **kw), batch):
            ref[ids.tobytes()] = row
    same = sum(torch.equal(o, ref[p.tobytes()])
               for o, p in zip(outs, prompts))
    if same != n or h["served"] != n:
        fail(f"batching: {same} of {n} answers equal their batch's rows "
             f"through {engine.__name__}; health {h}")
    return [len(x) for x in batches], wall, h, wait


def _family_batching(ptt, model, dev, card, gen):
    """(d) ``BatchingPredictor``: 8 concurrent submits through its own
    engine call, ``Predictor.run`` (each answer's logits bit for bit its
    row of the same stacked batch through ``Predictor.run``); then 16
    through ``Predictor.generate`` (set as the predictor's engine call),
    each answer bit for bit its row of the same batch through it."""
    V = model.config.vocab_size
    for engine, n, s, kw in (("run", 8, 64, {}),
                             ("generate", 16, 256,
                              dict(max_new_tokens=32))):
        bp = ptt.BatchingPredictor(model, device=dev, max_batch=8,
                                   max_delay_ms=50)
        prompts = torch.randint(0, V, (n, s), generator=gen,
                                device=dev).cpu().numpy()
        sizes, wall, h, wait = _batched(
            bp, prompts, getattr(bp.predictor, engine), **kw)
        log(f"[family] (d) BatchingPredictor(max_batch 8, max_delay_ms 50) "
            f"over Predictor.{engine} ({s}"
            + (f" + {kw['max_new_tokens']}" if kw else "")
            + f" tokens): {n} concurrent submits in {wall:.2f} s, batches "
            f"formed {sizes}, every answer bit for bit its row of the same "
            f"batch through Predictor.{engine}; queue wait ms: count "
            f"{wait['count']}, p50 {wait.get('p50')}, p99 "
            f"{wait.get('p99')}, max {wait.get('max')}; health {h} [{card}]")


def _family_hf(ptt, dev, card, seed):
    """(e) a 2-layer, full-width Llama-3-8B HF checkpoint (two shards and
    an index, bf16) written from the seed, then ``from_pretrained``: its
    parameters bit for bit those of ``load_jax_state_dict`` on the same
    arrays (and the written tensors), its logits those of the source."""
    from paddle_tpu_torch.convert import load_jax_state_dict
    from paddle_tpu_torch.models import hf_interop
    cfg = ptt.llama3_8b(num_hidden_layers=2)
    src = ptt.LlamaForCausalLM(cfg, device=dev,
                               generator=ptt.make_generator(seed + 50, dev))
    tensors = {k: v.detach().cpu() for k, v in src.state_dict().items()}
    d = tempfile.mkdtemp(prefix="hf_llama_")
    try:
        t0 = time.perf_counter()
        names = sorted(tensors)
        nbytes = _write_hf_llama(d, cfg, tensors)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = hf_interop.from_pretrained(d, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        arrays = {k: v.float().numpy() for k, v in tensors.items()}
        ref = ptt.LlamaForCausalLM(cfg, device=dev,
                                   generator=ptt.make_generator(1, dev))
        load_jax_state_dict(ref, hf_interop.convert_hf_state_dict(
            arrays, cfg, "llama"))
        got, want = model.state_dict(), ref.state_dict()
        bad = [k for k in want if not torch.equal(got[k], want[k])
               or not torch.equal(got[k].cpu(), tensors[k])]
        if bad or set(got) != set(want):
            fail(f"hf: from_pretrained parameters differ from "
                 f"load_jax_state_dict's on the same arrays: {bad[:4]}")
        ids = torch.randint(0, cfg.vocab_size, (2, 64), device=dev,
                            generator=ptt.make_generator(seed + 51, dev))
        with torch.inference_mode():
            same = torch.equal(model(ids), src(ids))
        if not same:
            fail("hf: the loaded model's logits differ from the source's")
        del arrays
        log(f"[family] (e) HF checkpoint: Llama-3-8B widths, 2 layers, bf16, "
            f"{len(names)} tensors in 2 shards + index, {nbytes / 1e9:.2f} GB "
            f"written in {t_write:.1f} s (no safetensors package); "
            f"from_pretrained onto the card in {t_load:.1f} s: every "
            f"parameter bit for bit load_jax_state_dict's on the same "
            f"arrays and the written tensors, logits the source's [{card}]")
        del model, ref
    finally:
        shutil.rmtree(d, ignore_errors=True)
        del src
        gc.collect()
        torch.cuda.empty_cache()


def phase_generate_family(seed, dev, card, model):
    """The rest of ``generate()`` on phase 6's Llama-3-8B (``[family]``
    lines): (a) beam search, (b) prompt-lookup and (c) draft-model
    speculative generate, (d) ``BatchingPredictor``, (e) an HF checkpoint
    through ``from_pretrained``. Each sub-run's counts are set to 0 just
    before it and read just after."""
    import paddle_tpu_torch as ptt
    t_phase = time.perf_counter()
    gen = ptt.make_generator(seed + 40, dev)
    _family_beam(ptt, model, dev, card, gen)
    _family_spec(ptt, model, dev, card, gen, seed)
    _family_batching(ptt, model, dev, card, gen)
    # the buffers of (a)-(d)'s programs, before (e) loads a checkpoint
    model._gen_exec_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    _family_hf(ptt, dev, card, seed)
    log(f"[family] the phase took {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")


# phase 7 (last): the host side of the user paths. The card machine has
# no tokenizer files and no ``tokenizers``: the script learns byte-level
# BPE merges from this fixed multilingual corpus by a greedy pair count
HOST_CORPUS = (
    "The quick brown fox jumps over the lazy dog, and the dog sleeps on.",
    "Serving large language models means batching requests of different "
    "lengths; left padding keeps every row's last token at one column.",
    "def train_step(model, batch):\n    loss = model(batch).mean()\n"
    "    return loss.backward()\n",
    "Der schnelle braune Fuchs springt über den faulen Hund.",
    "Le renard brun rapide saute par-dessus le chien paresseux, déjà vu.",
    "El rápido zorro marrón salta sobre el perro perezoso en España.",
    "Быстрая коричневая лиса прыгает через ленивую собаку.",
    "敏捷的棕色狐狸跳过了懒狗。大型语言模型的推理需要批处理。",
    "素早い茶色の狐がのろまな犬を飛び越える。東京は晴れです。",
    "빠른 갈색 여우가 게으른 개를 뛰어넘습니다.",
    "الثعلب البني السريع يقفز فوق الكلب الكسول.",
    "तेज़ भूरी लोमड़ी आलसी कुत्ते के ऊपर कूदती है।",
    "Numbers 0 7 42 1234 3.14159 2,718,281 and 2026-10-18T12:00:00Z.",
    "Emoji 🚀🤖🔥 and symbols ±×÷ → ∞ ≤ ≥ … «quotes» “smart”.",
    "don't can't won't it's we're I'll they'd you've SHE'S DON'T",
    "   leading spaces\tand\ttabs\nnewlines\r\nwindows line ends",
)
HOST_MERGES = 3000
# Llama-3's id layout: 128000 regular tokens (the learned ones, then
# three-byte fillers no merge makes, so that every id a random model
# emits decodes), then 256 special tokens
HOST_REGULAR = 128000
HOST_SPECIAL = {**{f"<|reserved_special_token_{i}|>": 128000 + i
                   for i in range(256)},
                "<|begin_of_text|>": 128000, "<|end_of_text|>": 128001,
                "<|eot_id|>": 128009}
HOST_PROMPTS = (
    "The quick brown fox",
    "Serving large language models means batching requests of different "
    "lengths; the pipeline left-pads them.",
    "敏捷的棕色狐狸跳过了懒狗。Der schnelle braune Fuchs springt über den "
    "faulen Hund. Быстрая коричневая лиса прыгает через ленивую собаку. "
    "Numbers 1234 3.14159 and 🚀🤖.",
    "def train_step(model, batch):",
)
HOST_NEW = 32
# hapi: ResNet-50 (fp32) through Model.fit, 8 steps of 32 seeded images
HOST_STEPS = 8
HOST_BATCH = 32
# Model.fit's losses against the same steps written out by hand, max
# |d| / |loss| (both run the same ops in the same order with cuDNN
# deterministic: expected bit for bit, this is the bound if they are not)
TOL_HAPI = 1e-5
HOST_TOOLS_TIMEOUT_S = 300


def _learn_bpe(corpus, n_merges, split_pattern):
    """Byte-level BPE merges by a greedy pair count: the corpus split by
    ``split_pattern``, each piece in GPT-2's byte alphabet; each round
    merges the most frequent adjacent pair (ties: the larger pair), until
    ``n_merges`` or no pair is left. Returns (vocab, merges): the 256
    byte symbols at ids 0-255, each merge's new token after them."""
    import re
    from collections import Counter

    from paddle_tpu_torch.tokenizer import bytes_to_unicode
    from paddle_tpu_torch.tokenizer.bpe import translate_split
    enc = bytes_to_unicode()
    split = re.compile(translate_split(split_pattern))
    words = Counter(tuple(enc[b] for b in piece.encode("utf-8"))
                    for line in corpus for piece in split.findall(line))
    vocab = {enc[b]: b for b in range(256)}
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        new = best[0] + best[1]
        vocab.setdefault(new, len(vocab))
        merged = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(new)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return vocab, merges


def _trie_reference(vocab, unk, text):
    """Greedy longest match over the UTF-8 bytes (the trie's rule: a later
    duplicate entry takes the id)."""
    table = {}
    for i, tok in enumerate(vocab):
        if tok:
            table[tok.encode("utf-8")] = i
    longest = max(len(k) for k in table)
    raw, out, i = text.encode("utf-8"), [], 0
    while i < len(raw):
        for n in range(min(longest, len(raw) - i), 0, -1):
            if raw[i:i + n] in table:
                out.append(table[raw[i:i + n]])
                i += n
                break
        else:
            out.append(unk)
            i += 1
    return out


def _host_native(seed, card):
    """(a) The native runtime built with this host's compiler, and its
    arena, gathers, ring and trie against numpy / Python."""
    import threading

    import numpy as np

    from paddle_tpu_torch import native
    t0 = time.perf_counter()
    native.lib()
    first_s = time.perf_counter() - t0
    rs = np.random.RandomState(seed + 90)
    pool = native.ThreadPool(8)
    arena = native.StagingArena(1 << 26)
    items = [rs.randn(3, 224, 224).astype(np.float32)
             for _ in range(HOST_BATCH)]
    got = native.gather_stack(pool, items, arena)
    stack_ok = np.array_equal(got, np.stack(items)) \
        and arena.used() >= got.nbytes
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        native.gather_stack(pool, items)
    native_ms = (time.perf_counter() - t0) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        np.stack(items)
    numpy_ms = (time.perf_counter() - t0) * 1e3 / reps
    arena.reset()
    seqs = [rs.randint(0, 128256, n) for n in rs.randint(0, 700, 64)]
    pad = native.gather_pad(pool, seqs, 512, pad_value=-1, dtype=np.int64,
                            arena=arena)
    want = np.full((64, 512), -1, np.int64)
    for i, q in enumerate(seqs):
        want[i, :min(len(q), 512)] = q[:512]
    pad_ok = np.array_equal(pad, want)
    ring, popped = native.Ring(64), []

    def consume():
        while (v := ring.pop(10_000)) is not None:
            popped.append(v)

    th = threading.Thread(target=consume)
    th.start()
    for v in range(20_000):
        ring.push(v, 10_000)
    ring.close()
    th.join(30)
    ring_ok = not th.is_alive() and popped == list(range(20_000))
    vocab = ["<unk>"] + sorted({w for line in HOST_CORPUS
                                for w in line.split()}) + list("abcde ")
    trie = native.Tokenizer(vocab, 0)
    texts = list(HOST_CORPUS)
    trie_ok = all(trie.encode(t).tolist() == _trie_reference(vocab, 0, t)
                  for t in texts)
    ids, lens = trie.encode_batch(texts, pool, max_len=64, pad_id=-1)
    trie_ok = trie_ok and all(
        ids[i, :lens[i]].tolist() == _trie_reference(vocab, 0, t)[:64]
        for i, t in enumerate(texts))
    log(f"[host] (a) native runtime: {' '.join(native.compiler())} "
        f"{' '.join(native.CXX_FLAGS)} built in {native.build_seconds:.2f} "
        f"s (first lib() call {first_s:.2f} s); gather_stack of "
        f"{HOST_BATCH} x [3, 224, 224] fp32 into the arena equal to "
        f"np.stack: {stack_ok} ({native_ms:.2f} ms on 8 threads against "
        f"np.stack's {numpy_ms:.2f} ms, host); gather_pad 64 rows to 512 "
        f"equal to numpy: {pad_ok}; ring 20000 values across threads in "
        f"order: {ring_ok}; trie tokenizer ({len(vocab)} entries) equal "
        f"to a Python longest match, alone and batched: {trie_ok} [{card}]")
    if not (stack_ok and pad_ok and ring_ok and trie_ok):
        fail(f"host (a): stack {stack_ok}, pad {pad_ok}, ring {ring_ok}, "
             f"trie {trie_ok}")


def _host_tokenizer(card):
    """(b) A byte-level BPE learned here, under LLAMA3_SPLIT: the native
    merge loop's ids against the Python loop's, and round trips."""
    from paddle_tpu_torch.tokenizer import LLAMA3_SPLIT, BPETokenizer
    from paddle_tpu_torch.tokenizer import bpe
    from paddle_tpu_torch.tokenizer import bytes_to_unicode
    t0 = time.perf_counter()
    vocab, merges = _learn_bpe(HOST_CORPUS, HOST_MERGES, LLAMA3_SPLIT)
    learn_s = time.perf_counter() - t0
    learned = len(vocab)
    alphabet = [bytes_to_unicode()[b] for b in range(256)]
    fillers = (a + b + c for a in alphabet for b in alphabet
               for c in alphabet)
    while len(vocab) < HOST_REGULAR:
        vocab.setdefault(next(fillers), len(vocab))
    special = {}
    for name, i in HOST_SPECIAL.items():     # the named ones win their ids
        special = {k: v for k, v in special.items() if v != i}
        special[name] = i
    tok = BPETokenizer(vocab, merges, special_tokens=special,
                       split_pattern=LLAMA3_SPLIT)
    if tok._native is None:
        fail("host (b): the learned vocab built no native merge loop")
    texts = list(HOST_CORPUS) + list(HOST_PROMPTS) + [
        "<|begin_of_text|>Hello<|eot_id|>", "ROMAN Ⅻ ⅷ ² ½ ٣٤٥",
        "next\u0085line sep​zero", "", "a"]
    c0 = dict(bpe.counts)
    same = sum(tok._native.encode_words(tok.pretokenize(t))
               == tok._convert(tok.tokenize(t)) for t in texts)
    trips = sum(tok.decode(tok.encode(t)) == t for t in texts)
    ran = {k: bpe.counts[k] - c0[k] for k in c0}
    top = max(max(vocab.values()), max(special.values()))
    big = "\n".join(HOST_CORPUS) * 40
    t0 = time.perf_counter()
    n_native = len(tok.encode(big))
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    n_python = len(tok._convert(tok.tokenize(big)))
    python_ms = (time.perf_counter() - t0) * 1e3
    log(f"[host] (b) BPE learned from the {len(HOST_CORPUS)}-line corpus "
        f"in {learn_s:.2f} s: {len(merges)} merges, {learned} learned "
        f"tokens (fillers to {len(vocab)}) + {len(special)} special, the "
        f"largest id {top} (< 128256); "
        f"LLAMA3_SPLIT on stdlib re: native ids equal to the Python loop's "
        f"on {same} of {len(texts)} strings, decode(encode(s)) == s on "
        f"{trips} of {len(texts)}; stretches encoded by loop {ran}; "
        f"{len(big)} characters ({n_native} ids) in {native_ms:.1f} ms "
        f"natively, {python_ms:.1f} ms through the Python loop "
        f"({n_python} ids; host) [{card}]")
    if same != len(texts) or trips != len(texts) or ran["python"] \
            or n_native != n_python or top >= 128256:
        fail(f"host (b): native == python on {same}, round trips {trips} of "
             f"{len(texts)}, loops {ran}, ids {n_native} vs {n_python}, "
             f"top id {top}")
    return tok


class _EncodeOnly:
    """A tokenizer without ``decode``: the pipeline then returns the new
    ids of each row (cut at eos)."""

    def __init__(self, tok):
        self.encode = tok.encode


def _host_pipeline(ptt, seed, dev, card, model, tok):
    """(b) TextGenerationPipeline on the 32-layer bf16 Llama-3-8B and on
    a small fp32 model: 4 prompts of different lengths, greedy."""
    from paddle_tpu_torch.generation import TextGenerationPipeline
    cfg = ptt.GenerationConfig(max_new_tokens=HOST_NEW)
    prompts = list(HOST_PROMPTS)
    enc = [tok.encode(p) for p in prompts]
    pipe = TextGenerationPipeline(model, tok, cfg)
    pipe(prompts)                                 # warm-up: captures
    read = _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = pipe(prompts)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read()
    rows = TextGenerationPipeline(model, _EncodeOnly(tok), cfg)(prompts)
    solo = []
    for e in enc:
        out = model.generate(torch.tensor([e], device=dev), config=cfg)
        solo.append(out[0, len(e):].tolist())
    equal = [r == s for r, s in zip(rows, solo)]
    gaps = [_teacher_gap(model, e, r) for e, r in zip(enc, rows)]
    solo_gaps = [_teacher_gap(model, e, s) for e, s in zip(enc, solo)]
    texts_ok = texts == [tok.decode(r, skip_special_tokens=True)
                         for r in rows]
    width = pipe._bucket(max(len(e) for e in enc))
    log(f"[host] (b) TextGenerationPipeline on Llama-3-8B (32 layers, "
        f"bf16): {len(prompts)} prompts of {[len(e) for e in enc]} tokens "
        f"left-padded to the {width} bucket, {HOST_NEW} greedy new tokens: "
        f"{wall_ms:.1f} ms, {wall_ms / HOST_NEW:.2f} ms a new token of the "
        f"batch ({wall_ms / HOST_NEW / len(prompts):.2f} ms a token), "
        f"tokenize and decode included; attention launches in the call "
        f"{ {k: v for k, v in launches.items() if v} } (a left-padded "
        f"batch attends densely, as in the JAX package); rows equal to "
        f"their solo generate() bit for bit: {equal}; teacher-forced gaps "
        f"of the padded rows {[round(g, 4) for g in gaps]}, of the solo "
        f"runs {[round(g, 4) for g in solo_gaps]} (tol {TOL_TEACHER}); "
        f"texts are the rows decoded: {texts_ok} [{card}]")
    log(f"[host] (b) the first text (random weights): {texts[0][:60]!r}")
    if any(launches.values()):
        fail(f"host (b): the left-padded pipeline launched kernels "
             f"{launches}")
    if max(gaps + solo_gaps) > TOL_TEACHER or not texts_ok:
        fail(f"host (b): teacher-forced gaps {gaps} / {solo_gaps} over "
             f"{TOL_TEACHER}, or texts differ from the rows")
    # bit for bit on a small fp32 model (no bf16 ties)
    small = ptt.LlamaForCausalLM(
        ptt.llama_tiny(vocab_size=model.config.vocab_size), device=dev,
        generator=ptt.make_generator(seed + 93, dev))
    rows = TextGenerationPipeline(small, _EncodeOnly(tok), cfg)(prompts)
    solo = [small.generate(torch.tensor([e], device=dev),
                           config=cfg)[0, len(e):].tolist() for e in enc]
    log(f"[host] (b) the same pipeline on llama_tiny (fp32, vocab "
        f"{small.config.vocab_size}): each padded row bit for bit its solo "
        f"generate(): {[r == s for r, s in zip(rows, solo)]} [{card}]")
    if rows != solo:
        fail("host (b): a padded fp32 row differs from its solo run")
    del small
    model._gen_exec_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _host_hapi(ptt, seed, dev, card, run_dir):
    """(c) ``ptt.Model(resnet50())``: fit over a native DataLoader, then
    evaluate and predict; the losses against the same steps by hand."""
    import numpy as np

    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.native import loader as native_loader
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.norm import running_stats_kept
    from paddle_tpu_torch.utils import observability as obs
    from paddle_tpu_torch.utils.logging import LogWriter
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    rs = np.random.RandomState(seed + 92)
    n = HOST_STEPS * HOST_BATCH
    images = rs.randn(n, 3, 224, 224).astype(np.float32)
    labels = rs.randint(0, 1000, n).astype(np.int64)
    net = resnet.resnet50(device=dev,
                          generator=ptt.make_generator(seed + 91, dev))
    hand = copy.deepcopy(net)
    buffers0 = {k: v.clone() for k, v in net.named_buffers()}
    model = ptt.Model(net).prepare(
        ptt.optimizer.AdamW(learning_rate=1e-4),
        loss=ptt.nn.CrossEntropyLoss(),
        metrics=ptt.metric.Accuracy(topk=(1, 5)))
    obs.configure(run_dir)
    writer = LogWriter(run_dir)
    marks = []

    class Clock:
        def on_train_batch_end(self, step, logs):   # float(loss) synced
            marks.append(time.perf_counter())
            ms = (marks[-1] - marks[-2]) * 1e3
            obs.record_event("step_end", step=step, ms=ms)
            obs.histogram("hapi_step_ms").observe(ms)
            obs.counter("hapi_steps_total").inc()
            writer.add_scalar("loss", logs["loss"], step)
            writer.add_scalar("images_per_sec", HOST_BATCH / ms * 1e3, step)

    loader = DataLoader(TensorDataset([images, labels]),
                        batch_size=HOST_BATCH, use_native=True)
    c0 = dict(native_loader.counts)
    read = _reset_launches()
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    with obs.span("hapi_fit", steps=HOST_STEPS):
        hist = model.fit(loader, epochs=1, log_freq=1, verbose=0,
                         callbacks=[Clock()])
    launches = read()
    fit_loader = {k: native_loader.counts[k] - c0[k] for k in c0}
    step_ms = np.diff(marks) * 1e3
    obs.publish(writer, HOST_STEPS)
    writer.close()
    obs.dump_flight("hapi_fit")      # the flight window, trace, metrics
    # the same steps by hand: forward, loss, autograd.grad, AdamW.apply
    params = dict(hand.named_parameters())
    opt = ptt.optimizer.AdamW(learning_rate=1e-4)
    state = opt.init(params)
    by_hand = []
    for i in range(HOST_STEPS):
        sl = slice(i * HOST_BATCH, (i + 1) * HOST_BATCH)
        x = torch.from_numpy(np.stack(list(images[sl]))).to(dev)
        y = torch.from_numpy(labels[sl]).to(dev)
        with running_stats_kept():
            loss = F.cross_entropy(hand(x), y).float()
        grads = torch.autograd.grad(loss, list(params.values()),
                                    materialize_grads=True)
        opt.apply(params, dict(zip(params, grads)), state, i)
        by_hand.append(float(loss.detach()))
    d_loss = max(abs(a - b) / abs(b) for a, b in zip(hist["loss"], by_hand))
    d_param = max(float((a - b).abs().max()) for a, b in zip(
        net.parameters(), hand.parameters()))
    kept = all(torch.equal(v, buffers0[k]) for k, v in net.named_buffers())
    c1 = dict(native_loader.counts)
    res = model.evaluate(DataLoader(TensorDataset([images[:64],
                                                   labels[:64]]),
                                    batch_size=HOST_BATCH, use_native=True),
                         verbose=0)
    preds = model.predict(DataLoader(TensorDataset([images[:64]]),
                                     batch_size=HOST_BATCH, use_native=True))
    rest_loader = {k: native_loader.counts[k] - c1[k] for k in c1}
    preds_ok = len(preds) == 2 and all(
        p.shape == (HOST_BATCH, 1000) and np.isfinite(p).all() for p in preds)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    steady = float(np.median(step_ms[1:]))
    want = dict(NO_LAUNCHES, fused_adamw=_update_launches(net, HOST_STEPS))
    log(f"[host] (c) ptt.Model(resnet50()) (fp32, cuDNN deterministic) "
        f".prepare(AdamW, nn.CrossEntropyLoss(), metric.Accuracy(topk=(1, "
        f"5))).fit over DataLoader(TensorDataset([images, labels]), "
        f"batch_size={HOST_BATCH}, use_native=True), {HOST_STEPS} steps: "
        f"losses {[round(v, 4) for v in hist['loss']]}; the same steps by "
        f"hand: bit for bit {hist['loss'] == by_hand} (max |d|/|loss| "
        f"{d_loss:.3g}, tol {TOL_HAPI}; parameters max |d| {d_param:.3g}); "
        f"BatchNorm's running statistics kept: {kept}; launches {launches} "
        f"(want {want}) [{card}]")
    log(f"[host] (c) a step {steady:.2f} ms (median of steps 2-"
        f"{HOST_STEPS}; the first {step_ms[0]:.2f} ms), "
        f"{HOST_BATCH / steady * 1e3:.1f} images/s; the loader's batches "
        f"by way: fit {fit_loader} (an (image, label) sample's label is a "
        f"numpy scalar, which sends the batch to collate_fn, as in the JAX "
        f"package), evaluate + predict {rest_loader}; evaluate {res}; "
        f"predict {len(preds)} x {preds[0].shape} finite: {preds_ok} "
        f"[{card}]")
    if launches != want or d_loss > TOL_HAPI or not kept or not preds_ok \
            or rest_loader["native"] != 2 or not np.isfinite(res["loss"]):
        fail(f"host (c): launches {launches} (want {want}), loss d {d_loss}, "
             f"buffers kept {kept}, predict {preds_ok}, loader "
             f"{rest_loader}, evaluate {res}")
    del model, net, hand, opt, state, params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _host_tools(card, gw_dir, host_dir):
    """(d) The four report tools, as ``python -m`` subprocesses, on the
    [gateway] phase's dumps and on this phase's run dir."""
    here = os.path.dirname(os.path.abspath(__file__))
    out_trace = os.path.join(host_dir, "waterfall.json")
    runs = {
        "trace_report --json (gateway)": ("trace_report", gw_dir, "--json"),
        "obs_report --json (gateway)": ("obs_report", gw_dir, "--json"),
        "obs_report --json (host)": ("obs_report", host_dir, "--json"),
        "fleet_dash (gateway)": ("fleet_dash", gw_dir),
        "trace_export --check (gateway)": ("trace_export", gw_dir, "-o",
                                           out_trace, "--check"),
        "obs_report --check": ("obs_report", "--check"),
    }
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", f"paddle_tpu_torch.tools.{v[0]}", *v[1:]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=here) for k, v in runs.items()}
    done = {}
    for k, p in procs.items():
        try:
            out, err = p.communicate(timeout=HOST_TOOLS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        done[k] = (p.returncode, out, err)
    wall = time.perf_counter() - t0
    bad = {k: (rc, err[-2000:]) for k, (rc, out, err) in done.items()
           if rc != 0 or not out.strip()}
    if bad:
        fail(f"host (d): tools failed: {bad}")
    tr = json.loads(done["trace_report --json (gateway)"][1])
    og = json.loads(done["obs_report --json (gateway)"][1])
    oh = json.loads(done["obs_report --json (host)"][1])
    with open(out_trace) as f:
        n_events = len(json.load(f)["traceEvents"])
    dash = done["fleet_dash (gateway)"][1].splitlines()
    log(f"[host] (d) the port's tools on the card machine (6 processes in "
        f"{wall:.1f} s, every exit 0): trace_report over "
        f"{len(tr.get('rings', []))} reqtrace rings, {tr.get('requests')} "
        f"requests ({tr.get('retained')} retained), classes "
        f"{sorted(tr.get('classes', {}))}; obs_report on the gateway dir: "
        f"phase_decompose {og.get('phase_decompose')}; on the host dir: "
        f"{oh.get('steps_recorded')} steps, step ms {oh.get('step_ms')}, "
        f"loss {oh.get('train', {}).get('loss')}; fleet_dash "
        f"{len(dash)} lines ({dash[0] if dash else ''!r}); trace_export "
        f"--check clean, {n_events} Chrome trace events; obs_report "
        f"--check: {done['obs_report --check'][1].strip()} [{card}]")
    if oh.get("steps_recorded") != HOST_STEPS or not tr.get("requests") \
            or not n_events:
        fail(f"host (d): steps {oh.get('steps_recorded')}, requests "
             f"{tr.get('requests')}, trace events {n_events}")


def phase_host(seed, dev, card, model, gw_dir):
    """The host side of the user paths (``[host]`` lines), after
    ``[family]`` on its Llama-3-8B: (a) the native runtime, (b) the BPE
    tokenizer and ``TextGenerationPipeline``, (c) ``paddle.Model`` with
    the loss layers and metrics over the native ``DataLoader``, (d) the
    report tools on the [gateway] phase's dumps and this phase's run dir.
    Returns (c)'s fused update launches."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.utils import observability as obs
    t_phase = time.perf_counter()
    host_dir = tempfile.mkdtemp(prefix="chip_smoke_host_")
    try:
        _host_native(seed, card)
        tok = _host_tokenizer(card)
        _host_pipeline(ptt, seed, dev, card, model, tok)
        try:
            launches = _host_hapi(ptt, seed, dev, card, host_dir)
        finally:
            obs.reset()      # flushes the run dir's span trace
        _host_tools(card, gw_dir, host_dir)
    finally:
        shutil.rmtree(host_dir, ignore_errors=True)
        shutil.rmtree(gw_dir, ignore_errors=True)
    log(f"[host] the phase took {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return {"fused_adamw": launches["fused_adamw"]}


def phase_spec_ragged_time(gen, dev, card):
    """The ragged kernel at the speculative verify's shape: q [16, 5, 32,
    128] over the engine's pools [1025, 16, 8, 128], bf16, seq_lens drawn
    from 64..1019, device time from a CUDA graph over copies larger than
    the L2; its plain version; SDPA on the same values (K/V pre-gathered
    and head-expanded, a per-(row, query) length mask; the port never
    calls it); the bound: each row's K/V of seq_len + 5 positions and q
    and out once, 4 d flops per (query head, query, attended position)."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain)
    R, T, h, kvh, d, B, M = 16, 5, 32, 8, 128, 16, 64
    lens = torch.randint(64, M * B - T, (R,), generator=gen, device=dev)
    kv_pos = int((lens + T).sum())
    att = int((T * (lens + 1) + T * (T - 1) // 2).sum())
    call_bytes = 2 * (2 * kv_pos * kvh * d + 2 * R * T * h * d)
    n = copies_for(call_bytes)
    sets = [paged_case(gen, dev, lens, T=T) for _ in range(n)]
    lib_sets, mask = sdpa_inputs(sets, lens, T)
    lib_ms = cuda_ms(lambda i: TF.scaled_dot_product_attention(
        *lib_sets[i % n], attn_mask=mask), iters=200)
    ms = graph_ms(lambda i: ragged_paged_attention(*sets[i % n]), calls=40)
    plain_ms = cuda_ms(lambda i: ragged_paged_attention_plain(*sets[i % n]),
                       iters=20)
    bound_ms, bound_by = bound(call_bytes, 4 * d * h * att)
    log(f"[spec] ragged at the verify's shape q [16, 5, 32, 128], pools "
        f"[1025, 16, 8, 128], bf16: kernel {ms:.4f} ms (device time, CUDA "
        f"graph), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {call_bytes / 1e6:.1f} MB) "
        f"[{card}]")
    del sets, lib_sets
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _device_profile(pred, ids, new_tokens, ptt):
    """(wall ms, {category: device ms}, device events) of one generate
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = ptt.GenerationConfig(max_new_tokens=new_tokens)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.generate(ids, config=cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cats = {"decode_attention": 0.0, "flash_attention": 0.0,
            "quant_matmul": 0.0, "gemm": 0.0, "other": 0.0}
    n = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n += 1
        name = e.name.lower()
        cat = ("decode_attention" if "decode_mma_kernel" in name
               or "decode_simt_kernel" in name else
               "flash_attention" if "flash_fwd_" in name else
               "quant_matmul" if "qmm_" in name else
               "gemm" if any(w in name for w in ("gemm", "gemv", "xmma",
                                                 "cutlass", "nvjet"))
               else "other")
        cats[cat] += e.time_range.elapsed_us() / 1e3
    return wall, cats, n


def profile_decode_step(ptt, pred, ids, step_ms, card, label):
    """Where a decode step's time goes: torch.profiler over a generate of
    1 and of 33 new tokens; the difference over 32 is one decode step's
    device time by kernel kind. Device busy share = that time over the
    unprofiled step (``step_ms``, the main run); host idle = the
    unprofiled step less the device's busy time. (The profiled wall is
    not used: with the step one graph replay, the host runs ahead of the
    card and the two generates' profiler costs differ by more than the
    32 steps take.)"""
    # warm: the 33-token program captures its step
    pred.generate(ids, config=ptt.GenerationConfig(max_new_tokens=33))
    _, c1, n1 = _device_profile(pred, ids, 1, ptt)
    _, c33, n33 = _device_profile(pred, ids, 33, ptt)
    steps = 32
    if n33 == n1:
        log("[profile] torch.profiler recorded no device events: device "
            "busy share not measured")
        return
    per = {k: (c33[k] - c1[k]) / steps for k in c33}
    busy = sum(per.values())
    log(f"[profile] {label} decode step: device busy {busy:.3f} ms, "
        f"{100 * busy / step_ms:.1f} % of the unprofiled {step_ms:.2f} ms "
        f"step (host idle {max(step_ms - busy, 0.0):.3f} ms of it), "
        f"{(n33 - n1) / steps:.0f} device ops per step; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in per.items())
        + f" [{card}]")


# ------------------------------------------------------ quantized serving
def phase_grid_checks(gen, dev):
    """The grid paged kernel against its plain version at the engine's
    geometry (R 16, h 32 over kvh 8, d 128, B 16, M 64, P 1025; lens with
    0, block edges and a row at M * B - 1), bf16 and fp16 (mma) and fp32
    (simt), with and without a window, each call on its route by count
    and repeated bit for bit. Every table slot past a row's live count
    holds an index far outside the pool, which the kernel must never read
    (the plain version gathers whole tables, so it gets those slots
    zeroed). Without a window the kernel is also held against the ragged
    kernel: bit for bit in fp32 (both keep the first design there),
    within the tolerance in bf16 and fp16 (two split-KV designs). Last,
    one call captured in a CUDA graph and replayed after seq_lens and
    tables changed in place. Returns the bf16 no-window error."""
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        grid_route, paged_attention, paged_attention_plain)
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention
    B, M = PAGED["block_size"], PAGED["max_blocks_per_seq"]
    first = None
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float16, TOL_FP16),
                       (torch.float32, TOL_FP32)):
        route = grid_route(dtype, 128)
        for window in (None, 100):
            lens = ragged_lens(gen, dev, 1)
            q, kp, vp, tbl, sl = paged_case(gen, dev, lens, dtype=dtype)
            dead = (torch.arange(M, device=dev)[None, :]
                    >= ((sl.long() + B) // B)[:, None])
            before = dict(paged_attention.launches_by_route)
            out = paged_attention(q, kp, vp, tbl.masked_fill(dead, 1 << 30),
                                  sl, window=window)
            again = paged_attention(q, kp, vp, tbl, sl, window=window)
            torch.cuda.synchronize()
            before[route] += 2
            if paged_attention.launches_by_route != before:
                fail(f"grid {dtype}: launches by route "
                     f"{paged_attention.launches_by_route} != {before}")
            ref = paged_attention_plain(q, kp, vp, tbl.masked_fill(dead, 0),
                                        sl, window=window)
            err = max_err(out, ref)
            same = torch.equal(out, again)
            note = ""
            if window is None:
                rag = ragged_paged_attention(q, kp, vp, tbl, sl)
                pinned = torch.equal(out, rag)
                note = (f"; against the ragged kernel: bit for bit "
                        f"{pinned}, max |d| {max_err(out, rag):.3e}")
                # fp32: both keep the first design's tiles and order of
                # sums; bf16 and fp16: two split-KV designs on mma
                if dtype == torch.float32 and not pinned:
                    fail("grid kernel differs from the ragged simt kernel "
                         "in fp32")
                if max_err(out, rag) > tol:
                    fail(f"grid and ragged kernels disagree ({dtype})")
            log(f"[check] grid {str(dtype)[6:]} ({route}) window {window} q "
                f"{list(q.shape)} pools {list(kp.shape)} seq_lens "
                f"{lens[:4]}+random, dead slots -> 2^30: max_abs_err "
                f"{err:.3e} tol {tol}; bitwise repeat {same}{note}")
            if not err <= tol:
                fail(f"grid kernel disagrees with its plain version "
                     f"({dtype}, window {window})")
            if not same:
                fail(f"grid kernel does not repeat ({dtype}, window {window})")
            if first is None:
                first = err
    q, kp, vp, tbl, sl = paged_case(gen, dev, ragged_lens(gen, dev, 1))
    paged_attention(q, kp, vp, tbl, sl, window=100)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention(q, kp, vp, tbl, sl, window=100)
    for _ in range(2):
        _, _, _, tbl2, sl2 = paged_case(gen, dev, ragged_lens(gen, dev, 1))
        tbl.copy_(tbl2)
        sl.copy_(sl2)
        graph.replay()
        torch.cuda.synchronize()
        err = max_err(out, paged_attention_plain(q, kp, vp, tbl, sl,
                                                 window=100))
        log(f"[check] grid CUDA-graph replay (window 100) after in-place "
            f"seq_lens / table change: max_abs_err {err:.3e} tol {TOL_BF16}")
        if not err <= TOL_BF16:
            fail("grid kernel replayed from a CUDA graph disagrees")
    return first


def _quantized(gen, dev, din, dout, bits):
    """Codes and scales of a random [din, dout] weight (std 0.02, as the
    model's init), quantized on the card."""
    from paddle_tpu_torch.quant import quantize_blockwise
    return quantize_blockwise(
        torch.randn(din, dout, generator=gen, device=dev) * 0.02, bits)


def phase_quant_checks(gen, dev):
    """The quant kernel against its plain version on the card: bf16
    activations with m in {1, 4, 16, 64} rows, every Llama-3-8B
    projection shape, int8 and int4; each call made twice must give the
    same bits. Returns the largest error."""
    from paddle_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul, quant_matmul_plain)
    worst = 0.0
    for bits in (8, 4):
        for din, dout in QUANT_SHAPES:
            qw, sc = _quantized(gen, dev, din, dout, bits)
            line, top = [], 0.0
            for m in (1, 4, 16, 64):
                x = torch.randn(m, din, generator=gen,
                                device=dev).to(torch.bfloat16)
                out = quant_matmul(x, qw, sc, bits)
                again = quant_matmul(x, qw, sc, bits)
                torch.cuda.synchronize()
                ref = quant_matmul_plain(x, qw, sc, bits).float()
                d = (out.float() - ref).abs()
                top = max(top, float(ref.abs().max()))
                ok = bool((d <= TOL_QUANT_REL * ref.abs()
                           + TOL_QUANT_ABS * float(ref.abs().max())).all())
                same = torch.equal(out, again)
                line.append(f"m={m} {float(d.max()):.3e}")
                if not ok:
                    fail(f"quant kernel disagrees with its plain version: "
                         f"int{bits} {din}->{dout} m={m}")
                if not same:
                    fail(f"quant kernel does not repeat: int{bits} "
                         f"{din}->{dout} m={m}")
                worst = max(worst, float(d.max()))
            log(f"[check] quant int{bits} {din}->{dout} bf16, max_abs_err "
                + ", ".join(line) + f" (max|ref| {top:.2f}; tol "
                f"2^-7 |ref| + {TOL_QUANT_ABS} max|ref|); bitwise repeat")
    return worst


def _simt_quant(x, qw, sc, bits):
    """The CUDA-core quant kernel (the route bf16 took before the mma
    kernel) on bf16 activations: for its time beside the new kernel's
    only, outside every counted run."""
    from paddle_tpu_torch.ops.kernels import _build, sm_count, stream_of
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    m, din = x.shape
    dout = qw.shape[1]
    out = torch.empty(m, dout, dtype=x.dtype, device=x.device)
    splits = qm.splits_for(m, din, dout, sm_count(x))
    partial = (torch.empty(splits, m, dout, dtype=torch.float32,
                           device=x.device) if splits > 1 else out)
    fn = _build.entry("quant_matmul", "quant_matmul_fwd_simt",
                      qm._ARGTYPES["simt"])
    rc = fn(x.data_ptr(), qw.data_ptr(), sc.data_ptr(), out.data_ptr(),
            partial.data_ptr(), m, din, dout, bits, qm.row_chunk(m), splits,
            qm.DTYPES[x.dtype], stream_of(x))
    _build.check("quant_matmul", rc)
    return out


def phase_quant_times(gen, dev, card):
    """The quant kernel at every projection shape, int8 and int4, m = 4
    (``generate``'s decode), 16 (a paged tick), 32 and 64, codes and
    scales rotated through copies larger than the L2, timed as device
    time per call from a CUDA graph of back-to-back calls (``graph_ms``:
    these kernels are shorter than their wrapper's host time; the eager
    per-call time, which is the host's, is printed beside the gate's). At
    gate_proj 4096->14336 also the CUDA-core kernel of the first port on
    the same bf16 inputs, the plain version and, as the yardstick the
    port never calls, one ``torch.matmul`` of the bf16 activations with
    the pre-dequantized bf16 weight (an unquantized model's projection),
    timed the same way. Bound: the codes, scales, activations and output
    once over 3.35 TB/s, against 2 m din dout FLOP at the bf16 rate.
    Returns the int8, m = 4 gate row."""
    from paddle_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul, quant_matmul_plain)
    from paddle_tpu_torch.quant import dequantize_weight
    rows, others = {}, []
    for bits in (8, 4):
        for din, dout in QUANT_SHAPES:
            code_bytes = din * dout * bits // 8
            n = copies_for(code_bytes)
            sets = [_quantized(gen, dev, din, dout, bits) for _ in range(n)]
            gate = (din, dout) == (4096, 14336)
            ws = ([dequantize_weight(q, s, bits, dtype=torch.bfloat16)
                   for q, s in sets] if gate else None)
            for m in (4, 16, 32, 64):
                x = torch.randn(m, din, generator=gen,
                                device=dev).to(torch.bfloat16)
                nbytes = (code_bytes + 2 * (din // 128) * dout
                          + 2 * m * (din + dout))
                bound_ms, bound_by = bound(nbytes, 2 * m * din * dout)
                ms = graph_ms(lambda i: quant_matmul(x, *sets[i % n], bits),
                              calls=60)
                if not gate:
                    others.append(f"int{bits} {din}->{dout} m={m} {ms:.4f}"
                                  f" ms (bound {bound_ms:.4f})")
                    continue
                eager_ms = cuda_ms(lambda i: quant_matmul(x, *sets[i % n],
                                                          bits), iters=200)
                simt_ms = graph_ms(lambda i: _simt_quant(x, *sets[i % n],
                                                         bits), calls=60)
                plain_ms = graph_ms(lambda i: quant_matmul_plain(
                    x, *sets[i % n], bits), calls=6)
                lib_ms = graph_ms(lambda i: torch.matmul(x, ws[i % n]),
                                  calls=60)
                rows[(bits, m)] = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=lib_ms, bound_ms=bound_ms,
                                       bound_by=bound_by, eager_ms=eager_ms,
                                       simt_ms=simt_ms)
            del sets, ws
    log(f"[time] quant, other projections (kernel on the card, bound): "
        + "; ".join(others) + f" [{card}]")
    # the host's pace per projection call: k/v (4096 -> 1024) at m = 4,
    # whose kernels are shorter than any call's host time, eager under
    # inference_mode as the serving paths run; the device idles between
    # calls, so these are host times
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.quant import QuantizedLinear
    lin = ptt.nn.Linear(4096, 1024, generator=gen, has_bias=False,
                        device=dev, dtype=torch.bfloat16)
    qlin = QuantizedLinear.from_linear(lin, bits=8)
    x3 = torch.randn(4, 1, 4096, generator=gen, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        host = {"bf16 Linear": cuda_ms(lambda i: lin(x3), iters=300),
                "int8 QuantizedLinear": cuda_ms(lambda i: qlin(x3),
                                                iters=300)}
    log(f"[time] one projection call at the host's pace (k/v 4096->1024, "
        f"x [4, 1, 4096] bf16, eager): "
        + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in host.items())
        + f" [{card}]")
    for (bits, m), r in rows.items():
        log(f"[time] quant int{bits} gate_proj 4096->14336 m={m}: kernel "
            f"{r.pop('eager_ms'):.4f} ms a call eager (the host's pace), "
            f"{r['ms']:.4f} ms on the card (mma); the first port's simt "
            f"kernel on the same inputs {r.pop('simt_ms'):.4f} ms; plain "
            f"{r['plain_ms']:.4f} ms, "
            f"bf16 matmul on the dequantized weight {r['library_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
    return rows[(8, 4)]


def phase_small_quant(dev):
    """A small fp32 Llama (hidden 256, ffn 512, 4/2 heads: every
    projection passes the kernel's gate; ``llama_tiny``'s hidden 64 would
    quantize nothing it admits) through ``Predictor`` with int8 and with
    int4 weight-only quantization, the same weights quantized on the CPU
    for both: logits of a 128-token prefill (the dequant route) and of 4
    decode steps (the quant kernel, 7 x 2 layers a step) on the card
    against the CPU (plain versions)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul
    cfg = ptt.llama_tiny(hidden_size=256, intermediate_size=512,
                         num_attention_heads=4, num_key_value_heads=2,
                         vocab_size=1024, max_position_embeddings=512)
    ids = torch.randint(0, cfg.vocab_size, (2, 132),
                        generator=ptt.make_generator(6, "cpu"))
    steps = [(ids[:, :128], 0)] + [(ids[:, t:t + 1], t)
                                   for t in range(128, 132)]
    for bits in (8, 4):
        preds = {}
        for where in ("cpu", dev):
            model = ptt.LlamaForCausalLM(
                cfg, device="cpu", generator=ptt.make_generator(5, "cpu"))
            preds[where] = ptt.Predictor(
                model, ptt.Config().enable_weight_only_quant(bits),
                device=where)
        worst = 0.0
        n0 = quant_matmul.launches
        with torch.inference_mode():
            caches = {w: p.model.init_kv_caches(2, 132)
                      for w, p in preds.items()}
            for chunk, ci in steps:
                ref, caches["cpu"] = preds["cpu"].model(
                    chunk, kv_caches=caches["cpu"], cache_index=ci)
                got, caches[dev] = preds[dev].model(
                    chunk.to(dev), kv_caches=caches[dev], cache_index=ci)
                if not torch.isfinite(got).all():
                    fail(f"small int{bits} model: non-finite logits on the "
                         f"card")
                worst = max(worst, max_err(got.cpu(), ref))
        launched = quant_matmul.launches - n0
        want = QUANT_PER_LAYER * cfg.num_hidden_layers * 4
        log(f"[small] fp32 Llama hidden 256, int{bits} weight-only, prefill "
            f"128 + 4 decode steps, card vs CPU: max_abs_err {worst:.3e} "
            f"tol {TOL_SMALL_LOGITS}; quant launches {launched} (want "
            f"{want})")
        if not worst <= TOL_SMALL_LOGITS:
            fail(f"small int{bits} model: card logits disagree with the CPU")
        if launched != want:
            fail(f"small int{bits} model: quant launches {launched} != "
                 f"{want}")


def _quantize_for_serving(ptt, model, bits, dev):
    """``Predictor(model, Config().enable_weight_only_quant(bits))``: the
    model is quantized in place, its bf16 projections freed. Returns the
    predictor and a line on the weights' bytes."""
    from paddle_tpu_torch.quant import QuantizedLinear
    t0 = time.perf_counter()
    pred = ptt.Predictor(model, ptt.Config().enable_weight_only_quant(bits),
                         device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    layers = [m for m in model.modules() if isinstance(m, QuantizedLinear)]
    want = QUANT_PER_LAYER * model.config.num_hidden_layers
    if len(layers) != want:
        fail(f"int{bits}: {len(layers)} projections quantized, want {want}")
    codes = sum(m.qweight.numel() for m in layers) / 1e9
    scales = sum(m.scales.numel() * 2 for m in layers) / 1e9
    total = _weight_gb(model)
    return pred, (f"{len(layers)} projections quantized in place in "
                  f"{seconds:.1f} s: weights {total:.2f} GB ({codes:.2f} GB "
                  f"codes, {scales:.3f} GB bf16 scales, "
                  f"{total - codes - scales:.2f} GB embedding, head and "
                  f"norms in bf16)"), total


def _against_bf16(label, pred, run, bf16, card):
    """The quantized run's numbers next to the bf16 run's, and its
    prefill's last-position logits against the bf16 model's."""
    logits = pred.run(bf16["ids"])[:, -1].float()
    if not torch.isfinite(logits).all():
        fail(f"{label}: non-finite prefill logits")
    b = bf16["ids"].shape[1]
    same_top = int((logits.argmax(-1) == bf16["logits"].argmax(-1)).sum())
    same_new = int((run["out"][:, b:] == bf16["out"][:, b:]).sum())
    log(f"[{label}] next to bf16: decode {run['decode_ms']:.2f} vs "
        f"{bf16['decode_ms']:.2f} ms/step, prefill {run['prefill_ms']:.1f} "
        f"vs {bf16['prefill_ms']:.1f} ms, peak memory {run['peak_gb']:.2f} "
        f"vs {bf16['peak_gb']:.2f} GB, weights {run['weight_gb']:.2f} vs "
        f"{bf16['weight_gb']:.2f} GB; prefill last-position logits max "
        f"|{label} - bf16| {max_err(logits, bf16['logits']):.3e} (max "
        f"|bf16 logit| {float(bf16['logits'].abs().max()):.3e}), argmax "
        f"equal in {same_top} of {logits.shape[0]} rows; greedy new tokens "
        f"equal to bf16's: {same_new} of {run['out'][:, b:].numel()} "
        f"[{card}]")


def phase_quant_slice(dev, card, model, bf16):
    """The slice with int8 weight-only quantization: phase 6's model
    quantized in place by ``Predictor``, then ``generate`` on the same 4 x
    512 prompts, 128 new, greedy. Launch counts: the quant kernel once per
    projection and decode step (the 2048-row prefill takes the dequant
    route), flash once per layer, decode once per layer and step."""
    import paddle_tpu_torch as ptt
    L = model.config.num_hidden_layers
    new = bf16["new"]
    pred, line, weight_gb = _quantize_for_serving(ptt, model, 8, dev)
    log(f"[int8] Predictor(Config().enable_weight_only_quant(8)): {line}")
    want = dict(NO_LAUNCHES, flash=L, decode=L * (new - 1),
                quant=QUANT_PER_LAYER * L * (new - 1))
    run = _generate_run(ptt, pred, bf16["ids"], new, want, "int8", dev, card)
    run["weight_gb"] = weight_gb
    _against_bf16("int8", pred, run, bf16, card)
    profile_decode_step(ptt, pred, bf16["ids"], run["decode_ms"], card,
                        "int8")
    return pred, run


def phase_quant_paged(seed, dev, card, model):
    """The paged path on the int8 model: ``PagedEngine`` at its defaults
    (the graphed device-resident tick) under ``PADDLE_TPU_PAGED_ATTN=grid``
    (set in the process and restored after) over 12 seeded requests, a
    third of them with prompts of at most 64 tokens (their whole-prompt
    prefill passes the quant gate), admission mid-decode. Counts, inside
    the graphs: grid once per layer and decode tick (on the mma route),
    ragged, flash and decode never, quant once per projection and (decode
    tick or short prefill). The host tick (``fused_tick=False``) must give
    the same tokens and logprobs, so must a rerun, and torch.profiler
    splits a steady tick (grid and quant kernels per tick, the grid
    attention's device time). Then the same requests under ``ragged``:
    its counts, and its tokens against the grid run's. Returns the grid
    run's launches and launches by route."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.generation.paged import PagedEngine
    cfg = model.config
    L = cfg.num_hidden_layers
    rs = np.random.RandomState(seed + 30)
    gen = ptt.make_generator(seed + 31, "cpu")
    subs = []
    for i in range(12):
        n = int(rs.randint(8, 65) if i % 3 == 0 else rs.randint(65, 769))
        subs.append((f"q{i}", torch.randint(0, cfg.vocab_size, (n,),
                                            generator=gen),
                     dict(max_new_tokens=int(rs.randint(32, 97)))))
    short = sum(len(ids) <= 64 for _, ids, _ in subs)
    prev = os.environ.get("PADDLE_TPU_PAGED_ATTN")
    runs = {}
    try:
        for mode in ("grid", "ragged"):
            os.environ["PADDLE_TPU_PAGED_ATTN"] = mode
            eng = PagedEngine(model, **PAGED)
            _serve(eng, subs[:2], late_after=0)      # warm-up, capture
            st0 = dict(eng.stats)
            read = _reset_launches()
            out, wall, ttft, _ = _serve(eng, subs, late_after=8)
            launches = read()
            lps = dict(eng.logprobs)
            ticks = eng.stats["decode_steps"] - st0["decode_steps"]
            prefills = eng.stats["prefills"] - st0["prefills"]
            preempted = eng.stats["preemptions"] - st0["preemptions"]
            want = dict(NO_LAUNCHES, quant=QUANT_PER_LAYER * L
                        * (ticks + short))
            want[mode] = L * ticks
            new_tokens = sum(len(v) for v in out.values())
            log(f"[int8 paged] PADDLE_TPU_PAGED_ATTN={mode}: 12 requests "
                f"({short} with prompts <= 64 tokens), {new_tokens} new "
                f"tokens in {ticks} decode ticks, {prefills} prefills, "
                f"{preempted} preemptions, {wall:.2f} s, "
                f"{new_tokens / wall:.1f} new tokens/s, TTFT median "
                f"{np.median(list(ttft.values())):.1f} ms; launches "
                f"{launches} (want {want}) [{card}]")
            if launches != want or prefills != len(subs) or preempted:
                fail(f"int8 paged ({mode}): launches {launches} != {want} "
                     f"or prefills {prefills} != {len(subs)} or "
                     f"{preempted} preemptions")
            routes = _check_routes(f"int8 paged ({mode})",
                                   quant=want["quant"],
                                   ragged=want["ragged"], grid=want["grid"])
            for rid, _, kw in subs:
                if len(out.get(rid, ())) != kw["max_new_tokens"]:
                    fail(f"int8 paged ({mode}): request {rid} was cut")
            if mode == "grid":
                host = PagedEngine(model, fused_tick=False, **PAGED)
                ref, hwall, _, _ = _serve(host, subs, late_after=8)
                _same_streams("int8 paged (grid)", out, lps, ref,
                              dict(host.logprobs))
                log(f"[int8 paged] grid: the host tick on the same "
                    f"submissions gave identical tokens and logprobs, "
                    f"{hwall:.2f} s against {wall:.2f} s [{card}]")
                del host
                again, _, _, _ = _serve(eng, subs, late_after=8)
                if again != out:
                    fail("int8 paged (grid): a rerun gave other tokens")
                log("[int8 paged] grid rerun of the same submissions: "
                    "identical tokens")
                profile_paged_tick(eng, lambda k: torch.randint(
                    0, cfg.vocab_size, (k,), generator=gen), card,
                    label="int8 grid",
                    expect={"grid_": L, "qmm_": QUANT_PER_LAYER * L})
            runs[mode] = (out, launches, routes)
            del eng
    finally:
        if prev is None:
            os.environ.pop("PADDLE_TPU_PAGED_ATTN", None)
        else:
            os.environ["PADDLE_TPU_PAGED_ATTN"] = prev
    grid, ragged = runs["grid"][0], runs["ragged"][0]
    same = sum(a == b for rid in grid
               for a, b in zip(grid[rid], ragged[rid]))
    total = sum(len(v) for v in grid.values())
    log(f"[int8 paged] grid vs ragged greedy tokens: {same} of {total} "
        f"equal; identical requests "
        f"{sum(grid[r] == ragged[r] for r in grid)} of {len(grid)}")
    return runs["grid"][1], runs["grid"][2]


def phase_int4(seed, dev, card, bf16):
    """int4: Llama-3-8B rebuilt from the seed at full width and depth and
    quantized in place with ``enable_weight_only_quant(4)``; ``generate``
    as in the int8 phase (quant launches 7 x layers x 127)."""
    import paddle_tpu_torch as ptt
    model = ptt.LlamaForCausalLM(ptt.llama3_8b(), device=dev,
                                 generator=ptt.make_generator(seed, dev))
    L = model.config.num_hidden_layers
    new = bf16["new"]
    pred, line, weight_gb = _quantize_for_serving(ptt, model, 4, dev)
    log(f"[int4] Predictor(Config().enable_weight_only_quant(4)), "
        f"{L} layers (full depth): {line}")
    want = dict(NO_LAUNCHES, flash=L, decode=L * (new - 1),
                quant=QUANT_PER_LAYER * L * (new - 1))
    run = _generate_run(ptt, pred, bf16["ids"], new, want, "int4", dev, card)
    run["weight_gb"] = weight_gb
    _against_bf16("int4", pred, run, bf16, card)
    profile_decode_step(ptt, pred, bf16["ids"], run["decode_ms"], card,
                        "int4")
    return pred


def phase_decode_ab(seed, dev, card, int4, ids):
    """The decode step of bf16 and int8 (the model rebuilt from the seed
    for each) and of the int4 predictor, ``generate`` on the same prompts,
    measured in turns (bf16, int8, int4, int4, int8, bf16) so that the
    host's drift between phases (the step is host-bound) falls on all
    three alike: each turn is a generate of 33 tokens less one of 1, over
    32 steps."""
    import paddle_tpu_torch as ptt
    preds = {}
    for key, config in (("bf16", ptt.Config()),
                        ("int8", ptt.Config().enable_weight_only_quant(8))):
        model = ptt.LlamaForCausalLM(ptt.llama3_8b(), device=dev,
                                     generator=ptt.make_generator(seed, dev))
        preds[key] = ptt.Predictor(model, config, device=dev)
        del model
    preds["int4"] = int4

    def timed(pred, new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.generate(ids, config=ptt.GenerationConfig(max_new_tokens=new))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    steps = {k: [] for k in preds}
    for key in ("bf16", "int8", "int4", "int4", "int8", "bf16"):
        timed(preds[key], 33)          # warm: captures the 33-token step
        timed(preds[key], 1)
        steps[key].append((timed(preds[key], 33) - timed(preds[key], 1))
                          / 32)
    mean = {k: sum(v) / len(v) for k, v in steps.items()}
    log(f"[decode A/B] ms per decode step, 4 x 512 prompts, in turns bf16, "
        f"int8, int4, int4, int8, bf16: "
        + "; ".join(f"{k} " + ", ".join(f"{x:.2f}" for x in v)
                    for k, v in steps.items())
        + f"; int8 / bf16 {mean['int8'] / mean['bf16']:.3f}, int4 / bf16 "
        f"{mean['int4'] / mean['bf16']:.3f} [{card}]")
    del preds
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------- training phases
def _bwd_inputs(gen, dev, dtype, b, s, h, kv, d, seg=False):
    """q, k, v, dout (seeded, on the card) and, with ``seg``, three packed
    segments per row and a pad tail (id 0)."""
    q = torch.randn(b, s, h, d, generator=gen, device=dev) * 0.5
    k = torch.randn(b, s, kv, d, generator=gen, device=dev) * 0.5
    v = torch.randn(b, s, kv, d, generator=gen, device=dev)
    g = torch.randn(b, s, h, d, generator=gen, device=dev)
    ids = None
    if seg:
        ids = torch.zeros(b, s, dtype=torch.int32, device=dev)
        ids[:, :s // 3], ids[:, s // 3:s // 2] = 1, 2
        ids[:, s // 2:s - 96] = 3
    return [t.to(dtype) for t in (q, k, v, g)] + [ids]


def phase_bwd_checks(gen, dev):
    """The dq and dk/dv kernels against the plain FA-2 backward on the
    card at sq = sk = 2048, GQA group 4: causal, causal with window 256,
    three packed segments with a pad tail, non-causal, d = 128 and 64, in
    bf16 and fp32; each run twice must give the same bits. Then
    FlashAttentionFunction forward + backward against torch autograd
    through dense_attention. The kernels line's errors come from
    phase_bwd_times, at the training shape."""
    from paddle_tpu_torch.ops.attention import dense_attention
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        FlashAttentionFunction, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd)
    cases = [("causal", 128, dict(causal=True)),
             ("causal window 256", 128, dict(causal=True, window=256)),
             ("segments", 128, dict(causal=True, seg=True)),
             ("non-causal", 128, dict(causal=False)),
             ("causal d=64", 64, dict(causal=True))]
    for dtype in (torch.bfloat16, torch.float32):
        for name, d, kw in cases:
            kw = dict(kw)
            q, k, v, g, seg = _bwd_inputs(gen, dev, dtype, *BWD_CHECK, d,
                                          seg=kw.pop("seg", False))
            kw["segment_ids"] = seg
            out, lse = flash_attention_fwd(q, k, v, **kw)
            got = flash_attention_bwd(q, k, v, out, lse, g, **kw)
            again = flash_attention_bwd(q, k, v, out, lse, g, **kw)
            torch.cuda.synchronize()
            ref = flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            line = []
            for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
                err, rmax = max_err(a, r), float(r.float().abs().max())
                line.append(f"{gname} {err:.3e} (max|ref| {rmax:.3e})")
                tol = (TOL_BWD_BF16 * rmax if dtype == torch.bfloat16
                       else TOL_FP32)
                if not err <= tol:
                    fail(f"flash backward {gname} disagrees with its plain "
                         f"version: {name}, {dtype}")
            log(f"[check] flash bwd {str(dtype)[6:]} {name} q "
                f"{list(q.shape)} kv {list(k.shape)}: " + ", ".join(line) + f"; bitwise repeat {same} "
                f"(tol {'2e-2 x max|ref|' if dtype == torch.bfloat16 else TOL_FP32})")
            if not same:
                fail(f"flash backward is not deterministic: {name}, {dtype}")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g, _ = _bwd_inputs(gen, dev, dtype, *BWD_CHECK, 128)
        grads = []
        for fn in ("flash", "flash", "dense"):
            # the reference: dense attention in fp32 on the same values
            cast = (lambda t: t) if fn == "flash" else (lambda t: t.float())
            xs = [cast(t).detach().requires_grad_() for t in (q, k, v)]
            out = (FlashAttentionFunction.apply(*xs, True)[0] if fn == "flash"
                   else dense_attention(*xs, causal=True))
            out.backward(cast(g))
            grads.append([x.grad for x in xs])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(grads[0], grads[1]))
        worst = max(max_err(a, r) / max(float(r.float().abs().max()), 1e-30)
                    for a, r in zip(grads[0], grads[2]))
        tol = TOL_BWD_BF16 if dtype == torch.bfloat16 else TOL_FP32
        log(f"[check] FlashAttentionFunction {str(dtype)[6:]} causal q "
            f"{list(q.shape)} kv {list(k.shape)}, forward + backward vs "
            f"autograd through "
            f"fp32 dense_attention: max |d| / max|ref| {worst:.3e} (tol "
            f"{tol}); "
            f"bitwise repeat {same}")
        if not (worst <= tol and same):
            fail(f"FlashAttentionFunction gradients disagree or do not "
                 f"repeat ({dtype})")


def phase_bwd_times(gen, dev, card):
    """The backward at the slice's shape: q [2,2048,32,128], k/v
    [2,2048,8,128], bf16, causal. First each kernel's output on these
    inputs against the plain twin (TOL_BWD_BF16 x max|ref|; these are the
    errors the kernels line reports). Then the times of the dq kernel, the
    dk/dv kernel and their sum; of each kernel's plain version (dq alone,
    dk and dv alone) and of the whole plain twin; and, as the yardstick
    the port never calls, of SDPA's backward on the same values asked for
    dq alone, for dk and dv alone, and for all three (heads expanded by a
    repeat_interleave inside the graph, so dk and dv include its sum)."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels.flash_attention import (
        _delta, flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
        flash_attention_bwd_dq, flash_attention_bwd_dq_plain,
        flash_attention_bwd_plain, flash_attention_fwd)
    b, s, h, kv, d = BWD_TIME
    el = 2
    q_bytes, kv_bytes = el * b * s * h * d, el * b * s * kv * d
    row_bytes = 4 * b * h * s                     # lse or delta, fp32
    # the whole function: q, k, v, out, dout, lse read; dq, dk, dv written
    fn_bytes = 4 * q_bytes + 4 * kv_bytes + row_bytes
    dq_bytes = 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes
    dkv_bytes = 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
    pairs = b * h * s * (s + 1) // 2
    prod = 2 * d * pairs                          # FLOP of one product
    n = copies_for(fn_bytes)
    sets = []
    for _ in range(n):
        q, k, v, g, _ = _bwd_inputs(gen, dev, torch.bfloat16, b, s, h, kv, d)
        out, lse = flash_attention_fwd(q, k, v, causal=True)
        sets.append((q, k, v, out, lse, g, _delta(out, g)))
    kw = dict(causal=True, scale=1.0 / d ** 0.5, window=None)

    def kargs(i):
        return [sets[i % n][j] for j in (0, 1, 2, 5, 4, 6)] + [None]

    errs = {}
    got = [flash_attention_bwd_dq(*kargs(0), **kw),
           *flash_attention_bwd_dkv(*kargs(0), **kw)]
    ref = flash_attention_bwd_plain(*sets[0][:6], causal=True)
    line = []
    for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
        err, rmax = max_err(a, r), float(r.float().abs().max())
        line.append(f"{gname} {err:.3e} (max|ref| {rmax:.3e})")
        if not err <= TOL_BWD_BF16 * rmax:
            fail(f"flash backward {gname} disagrees with its plain version "
                 f"at the training shape")
        key = "flash_bwd_dq" if gname == "dq" else "flash_bwd_dkv"
        errs[key] = max(errs.get(key, 0.0), err)
    log(f"[check] flash bwd bf16 causal at the training shape q "
        f"{[b, s, h, d]} kv {[b, s, kv, d]}: " + ", ".join(line)
        + " (tol 2e-2 x max|ref|)")
    del got, ref
    dq_ms = cuda_ms(lambda i: flash_attention_bwd_dq(*kargs(i), **kw),
                    iters=10)
    dkv_ms = cuda_ms(lambda i: flash_attention_bwd_dkv(*kargs(i), **kw),
                     iters=10)
    # the CUDA-core kernels that bf16 took before, on the same inputs
    dq_simt_ms = cuda_ms(lambda i: _simt_dq(*kargs(i)[:6]), iters=3,
                         warmup=1)
    dkv_simt_ms = cuda_ms(lambda i: _simt_dkv(*kargs(i)[:6]), iters=3,
                          warmup=1)
    plain = {}
    for key, fn in (("flash_bwd_dq", flash_attention_bwd_dq_plain),
                    ("flash_bwd_dkv", flash_attention_bwd_dkv_plain),
                    ("whole", flash_attention_bwd_plain)):
        plain[key] = cuda_ms(lambda i: fn(*sets[i % n][:6], causal=True),
                             iters=3, warmup=1)
    lib = []
    for q, k, v, out, lse, g, _ in sets:
        xs = [t.transpose(1, 2).contiguous().requires_grad_()
              for t in (q, k, v)]
        o = TF.scaled_dot_product_attention(
            xs[0], *[x.repeat_interleave(h // kv, 1) for x in xs[1:]],
            is_causal=True)
        lib.append((o, xs, g.transpose(1, 2).contiguous()))
    library = {}
    for key, which in (("flash_bwd_dq", [0]), ("flash_bwd_dkv", [1, 2]),
                       ("whole", [0, 1, 2])):
        library[key] = cuda_ms(lambda i: torch.autograd.grad(
            lib[i % n][0], [lib[i % n][1][j] for j in which], lib[i % n][2],
            retain_graph=True), iters=10)
    rows = {}
    for key, ms, nbytes, products in (("flash_bwd_dq", dq_ms, dq_bytes, 3),
                                      ("flash_bwd_dkv", dkv_ms, dkv_bytes,
                                       4)):
        bound_ms, bound_by = bound(nbytes, products * prod)
        rows[key] = dict(ms=ms, plain_ms=plain[key], library_ms=library[key],
                         bound_ms=bound_ms, bound_by=bound_by)
    rows["flash_bwd_dq"]["simt_ms"] = dq_simt_ms
    rows["flash_bwd_dkv"]["simt_ms"] = dkv_simt_ms
    fn_bound, fn_by = bound(fn_bytes, 5 * prod)
    log(f"[time] flash bwd at q {[b, s, h, d]} kv {[b, s, kv, d]} bf16 "
        f"causal: dq kernel {dq_ms:.4f} ms (simt kernel {dq_simt_ms:.4f} "
        f"ms; bound "
        f"{rows['flash_bwd_dq']['bound_ms']:.4f} ms, 3 products; plain dq "
        f"{plain['flash_bwd_dq']:.4f} ms; sdpa backward for dq "
        f"{library['flash_bwd_dq']:.4f} ms), dk/dv kernel {dkv_ms:.4f} ms "
        f"(simt kernel {dkv_simt_ms:.4f} ms; bound {rows['flash_bwd_dkv']['bound_ms']:.4f} ms, 4 products; "
        f"plain dk/dv {plain['flash_bwd_dkv']:.4f} ms; sdpa backward for "
        f"dk, dv {library['flash_bwd_dkv']:.4f} ms), sum "
        f"{dq_ms + dkv_ms:.4f} ms; the backward as a whole: bound "
        f"{fn_bound:.4f} ms ({fn_by}: 5 products, "
        f"{5 * prod / 1e9:.1f} GFLOP, {fn_bytes / 1e6:.1f} MB); plain "
        f"{plain['whole']:.4f} ms; sdpa backward for dq, dk, dv "
        f"{library['whole']:.4f} ms [{card}]")
    del sets, lib
    bwd_times_d64(gen, dev, card)
    return rows, errs


def bwd_times_d64(gen, dev, card):
    """The wgmma dq and dk/dv kernels at head_dim 64 (q [2,2048,32,64],
    k/v [2,2048,8,64], bf16, causal) beside their bounds and SDPA's
    backward asked for the same gradients, as phase_bwd_times does at
    128."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels.flash_attention import (
        _delta, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_fwd)
    b, s, h, kv, _ = BWD_TIME
    d, el = 64, 2
    q_bytes, kv_bytes = el * b * s * h * d, el * b * s * kv * d
    row_bytes = 4 * b * h * s
    prod = 2 * d * (b * h * s * (s + 1) // 2)
    n = copies_for(4 * q_bytes + 4 * kv_bytes + row_bytes)
    sets, lib = [], []
    for _ in range(n):
        q, k, v, g, _ = _bwd_inputs(gen, dev, torch.bfloat16, b, s, h, kv, d)
        out, lse = flash_attention_fwd(q, k, v, causal=True)
        sets.append((q, k, v, g, lse, _delta(out, g), None))
        xs = [t.transpose(1, 2).contiguous().requires_grad_()
              for t in (q, k, v)]
        o = TF.scaled_dot_product_attention(
            xs[0], *[x.repeat_interleave(h // kv, 1) for x in xs[1:]],
            is_causal=True)
        lib.append((o, xs, g.transpose(1, 2).contiguous()))
    kw = dict(causal=True, scale=d ** -0.5, window=None)
    parts = []
    for key, fn, which, nbytes, products in (
            ("dq", flash_attention_bwd_dq, [0],
             3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, 3),
            ("dk/dv", flash_attention_bwd_dkv, [1, 2],
             2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, 4)):
        ms = cuda_ms(lambda i: fn(*sets[i % n], **kw), iters=10)
        lib_ms = cuda_ms(lambda i: torch.autograd.grad(
            lib[i % n][0], [lib[i % n][1][j] for j in which], lib[i % n][2],
            retain_graph=True), iters=10)
        bound_ms, bound_by = bound(nbytes, products * prod)
        parts.append(f"{key} kernel {ms:.4f} ms (bound {bound_ms:.4f} ms, "
                     f"{bound_by}; sdpa backward for {key} {lib_ms:.4f} ms)")
    log(f"[time] flash bwd at d=64, q {[b, s, h, d]} kv {[b, s, kv, d]} bf16 "
        f"causal, wgmma: " + "; ".join(parts) + f" [{card}]")
    del sets, lib


def phase_train_small(dev):
    """One SGD Trainer step of a small fp32 Llama (head_dim 64, seq 128:
    the flash route) on the card (kernels) and on the CPU (plain
    versions) from the same weights and batch: the loss must agree within
    TOL_SMALL_LOGITS, and each parameter's update within TOL_SMALL_UPDATE
    of its largest element plus 1e-6, so that a fault in an attention
    gradient fails here too."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq)
    cfg = ptt.llama_tiny(hidden_size=256, num_attention_heads=4,
                         num_key_value_heads=2)
    cpu = ptt.LlamaForCausalLM(cfg, device="cpu",
                               generator=ptt.make_generator(3, "cpu"))
    gpu = ptt.LlamaForCausalLM(cfg, device=dev,
                               generator=ptt.make_generator(3, dev))
    gpu.load_state_dict(cpu.state_dict())
    before = {k: v.detach().clone().cpu() for k, v in cpu.named_parameters()}
    batch = [np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 128))]
    losses, updates = [], []
    n0 = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    for m in (gpu, cpu):
        args = ptt.TrainingArguments(output_dir="output/chip_smoke_small",
                                     max_steps=1, logging_steps=1)
        tr = ptt.Trainer(m, ptt.optimizer.SGD(learning_rate=1.0), args,
                         train_dataloader=batch)
        tr.train()
        losses.append(tr.logger.history["loss"][0][1])
        updates.append({k: v.detach().cpu() - before[k]
                        for k, v in m.named_parameters()})
    launched = (flash_attention_bwd_dq.launches - n0[0],
                flash_attention_bwd_dkv.launches - n0[1])
    worst = max(max_err(updates[0][k], updates[1][k]) for k in before)
    # each parameter's difference over what it may be
    share = max(max_err(updates[0][k], updates[1][k])
                / (TOL_SMALL_UPDATE * float(updates[1][k].abs().max())
                   + 1e-6) for k in before)
    qkv = min(float(updates[0][f"model.layers.{i}.self_attn.{p}_proj.weight"]
                    .abs().max()) for i in range(2) for p in "qkv")
    log(f"[small] fp32 Llama d=64, one SGD Trainer step on [2,128]: loss card "
        f"{losses[0]:.6f} vs CPU {losses[1]:.6f}; max |update difference| "
        f"{worst:.3e}, at most {share:.3f} of its tolerance "
        f"({TOL_SMALL_UPDATE} x the parameter's max |update| + 1e-6); "
        f"smallest max |q/k/v update| {qkv:.3e}; backward launches (dq, "
        f"dk/dv) {launched}")
    if not (abs(losses[0] - losses[1]) <= TOL_SMALL_LOGITS and share <= 1):
        fail("small model: the card's Trainer step disagrees with the CPU's")
    if launched != (2, 2) or not qkv > 0:
        fail("small model: attention gradients did not go through the "
             "backward kernels")


def _train_model(seed, dev, layers=TRAIN_LAYERS, **overrides):
    import paddle_tpu_torch as ptt
    cfg = ptt.llama3_8b(num_hidden_layers=layers, **overrides)
    return ptt.LlamaForCausalLM(cfg, device=dev,
                                generator=ptt.make_generator(seed, dev))


def _trainer(model, batches, steps, clock=None, prefetch_depth=2,
             output_dir="output/chip_smoke_train", scaler=None, **kw):
    """The training slice's Trainer at the JAX package's defaults
    (graceful shutdown on, resume on when save_steps is set): AdamW with
    fp32 masters, weight decay 0.01, a 2-step warm-up into a cosine over
    10, global-norm clipping at 1.0, logging every step."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.optimizer import lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(3e-4, T_max=10),
                            warmup_steps=2)
    opt = ptt.optimizer.AdamW(
        learning_rate=sched, weight_decay=0.01, multi_precision=True,
        grad_clip=ptt.optimizer.ClipGradByGlobalNorm(1.0))
    args = ptt.TrainingArguments(output_dir=output_dir, max_steps=steps,
                                 logging_steps=1,
                                 prefetch_depth=prefetch_depth, **kw)
    return ptt.Trainer(model, opt, args, train_dataloader=batches,
                       callbacks=[clock] if clock else None, scaler=scaler)


def profile_train_step(tr, step_ms, card,
                       label="train step (4 layers, [2,2048])",
                       before_ms=ADAM_BEFORE_MS):
    """torch.profiler over one more step of the trainer: device time by
    kind (weight matmuls, flash forward, dq, dk/dv, the optimizer's clip
    and update, other elementwise) and the device's busy share of the
    unprofiled median step. The optimizer's kernels are those that start
    inside the device-side span of its ``optimizer_apply`` range; the
    ranges' own device-side spans are not kernels and are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    spans = {"train_step", "optimizer_apply"}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train(max_steps=tr.global_step + 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = [e for e in device
              if getattr(e, "is_user_annotation", False) or e.name in spans]
    opt = [(e.time_range.start, e.time_range.end) for e in ranges
           if e.name == "optimizer_apply"]
    skip = {id(e) for e in ranges}
    kernels = [e for e in device if id(e) not in skip]
    cats = {"gemm": 0.0, "flash_fwd": 0.0, "flash_bwd_dq": 0.0,
            "flash_bwd_dkv": 0.0, "optimizer": 0.0, "other": 0.0}
    for e in kernels:
        name = e.name.lower()
        cat = ("flash_fwd" if "flash_fwd_" in name else
               "flash_bwd_dq" if "flash_bwd_dq_" in name else
               "flash_bwd_dkv" if "flash_bwd_dkv_" in name else
               "gemm" if any(w in name for w in ("gemm", "gemv", "xmma",
                                                 "cutlass", "nvjet"))
               else "other")
        if cat == "other" and any(a <= e.time_range.start <= b
                                  for a, b in opt):
            cat = "optimizer"
        cats[cat] += e.time_range.elapsed_us() / 1e3
    if not kernels:
        log("[profile] torch.profiler recorded no device events: train step "
            "split not measured")
        return None
    busy = sum(cats.values())
    note = ("" if opt else " (no device-side optimizer range: the optimizer "
            "is not measured apart and is counted in other)")
    fused = sum(e.time_range.elapsed_us() / 1e3 for e in kernels
                if "fused_adam" in e.name)
    log(f"[profile] {label}: under the profiler "
        f"{wall:.1f} ms, device busy {busy:.1f} ms ({100 * busy / step_ms:.1f}"
        f" % of the unprofiled median step {step_ms:.1f} ms), "
        f"{len(kernels)} device ops; "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in cats.items()) + note
        + f"; the optimizer's {cats['optimizer']:.2f} ms hold the fused "
        f"update kernel's {fused:.2f} ms"
        + (f" (the per-tensor update before it: {before_ms} ms)"
           if before_ms else "") + f" [{card}]")
    return cats


def phase_train(seed, dev, card):
    """The training slice: Llama-3-8B at full width, 4 layers, bf16, random
    weights from the seed, AdamW (fp32 masters, weight decay 0.01) with a
    2-step linear warm-up into a cosine over 10 and global-norm clipping
    at 1.0, through ``Trainer`` for 10 steps over 2 seeded [2, 2048]
    token batches, alternating, prefetch depth 2, logging every step.
    The counts are set to 0 just before the run and read just after:
    flash forward, dq and dk/dv once per layer and step, decode and
    ragged never. Then a profiled step; the feed A/B (prefetch depth 0
    against 2, FEED_STEPS steps a run); and a fresh model with
    recompute=True (policy full): its loss and gradients on batch 0 as
    without recompute, then 2 Trainer steps with the flash forward twice
    per layer and step and the plain run's losses."""
    import gc

    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.utils.profiler import StepTimer, device_peak_flops

    class StepClock(ptt.TrainerCallback):
        """Host time at the end of each logged step (after the loss's
        sync)."""

        def __init__(self):
            self.t = []

        def on_step_end(self, step, logs):
            self.t.append(time.perf_counter())

    rs = np.random.RandomState(seed + 20)
    model = _train_model(seed, dev)
    cfg = model.config
    batches = [rs.randint(0, cfg.vocab_size, TRAIN_BATCH) for _ in range(2)]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] Llama-3-8B width (hidden {cfg.hidden_size}, ffn "
        f"{cfg.intermediate_size}, heads {cfg.num_attention_heads}/"
        f"{cfg.num_key_value_heads}, vocab {cfg.vocab_size}), "
        f"{cfg.num_hidden_layers} layers, {cfg.dtype}: "
        f"{n_params / 1e9:.3f} B params; batch {list(TRAIN_BATCH)}")
    clock = StepClock()
    tr = _trainer(model, batches, TRAIN_STEPS, clock)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    read = _reset_launches()
    clock.t = [time.perf_counter()]
    tr.train()
    torch.cuda.synchronize()
    launches = read()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    L = cfg.num_hidden_layers
    # the fused update: one launch a step (one parameter/gradient type)
    want = dict(NO_LAUNCHES, flash=L * TRAIN_STEPS,
                flash_bwd_dq=L * TRAIN_STEPS, flash_bwd_dkv=L * TRAIN_STEPS,
                fused_adamw=TRAIN_STEPS)
    losses = [v for _, v in tr.logger.history["loss"]]
    log(f"[train] launches in {TRAIN_STEPS} steps: {launches} (want {want})")
    log(f"[train] losses per step: " + ", ".join(f"{x:.4f}" for x in losses))
    if launches != want:
        fail(f"training launches {launches} != {want}")
    routes = _check_routes("train", flash=L * TRAIN_STEPS,
                           flash_bwd_dq=L * TRAIN_STEPS,
                           flash_bwd_dkv=L * TRAIN_STEPS)
    from paddle_tpu_torch.ops.kernels.fused_adam import fused_adam
    routes["fused_adamw"] = dict(fused_adam.launches_by_route)
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail("training loss is not finite at every step")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall: step 1 {losses[0]:.4f}, step "
             f"{TRAIN_STEPS} {losses[-1]:.4f}")
    steps_ms = np.diff(clock.t) * 1e3
    step_ms = float(np.median(steps_ms[2:]))
    tokens = TRAIN_BATCH[0] * TRAIN_BATCH[1]
    tps = tokens / (step_ms / 1e3)
    timer = StepTimer(flops_per_token=tr._derived_flops,
                      peak_flops=device_peak_flops())
    log(f"[train] step ms (host clock, loss synced): "
        + ", ".join(f"{x:.1f}" for x in steps_ms)
        + f"; median of steps 3-{TRAIN_STEPS} {step_ms:.1f} ms, "
        f"{tps:.0f} tokens/s, {tr._derived_flops * tokens / 1e12:.2f} TFLOP"
        f"/step (6N + attention), MFU {100 * timer.mfu_at(tps):.2f} % of "
        f"{timer.peak_flops / 1e12:.0f} TFLOP/s, peak memory {peak_gb:.2f} GB"
        f" [{card}]")
    profile_train_step(tr, step_ms, card)
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # the feed: the same model trained on by fresh Trainers that prefetch
    # (depth 2, the default) or feed inline (depth 0) from the batch list,
    # or prefetch from a DataLoader with two spawned workers over the same
    # token rows, in the order 0, 2, loader, loader, 2, 0; the median of
    # each run's steps 3 to FEED_STEPS
    from paddle_tpu_torch.io import DataLoader, Subset
    rows = np.concatenate(batches)
    feed = {0: [], 2: [], "loader": []}
    for arm in (0, 2, "loader", "loader", 2, 0):
        clock = StepClock()
        data = batches
        if arm == "loader":
            data = DataLoader(Subset(rows, list(range(len(rows)))),
                              batch_size=TRAIN_BATCH[0], num_workers=2,
                              persistent_workers=True)
        tr = _trainer(model, data, FEED_STEPS, clock, 0 if arm == 0 else 2)
        torch.cuda.synchronize()
        clock.t = [time.perf_counter()]
        tr.train()
        torch.cuda.synchronize()
        feed[arm].append(float(np.median(np.diff(clock.t)[2:])) * 1e3)
        if arm == "loader":
            data.shutdown()
        del tr, data
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[train] feed A/B, median step ms of steps 3-{FEED_STEPS} (host "
        f"clock, loss synced), runs in the order 0, 2, loader, loader, 2, "
        f"0: prefetch_depth=0 " + ", ".join(f"{x:.2f}" for x in feed[0])
        + "; prefetch_depth=2 " + ", ".join(f"{x:.2f}" for x in feed[2])
        + "; DataLoader(num_workers=2) with prefetch_depth=2 "
        + ", ".join(f"{x:.2f}" for x in feed["loader"]) + f" [{card}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    model = _train_model(seed, dev, recompute=True, recompute_policy="full")
    # recompute changes memory, not math: the loss and every gradient on
    # batch 0 with the per-layer recompute and without it, same weights
    ids = torch.as_tensor(batches[0], device=dev).long()
    grads = {}
    for on in (True, False):
        model.config.recompute = on
        loss = ptt.causal_lm_loss(model(ids), ids)
        grads[on] = [loss.detach()] + list(torch.autograd.grad(
            loss, list(model.parameters())))
        del loss
    model.config.recompute = True
    share = max(max_err(a, r) / max(float(r.float().abs().max()), 1e-30)
                for a, r in zip(grads[True], grads[False]))
    same = sum(torch.equal(a, r) for a, r in zip(grads[True], grads[False]))
    log(f"[train] recompute=True vs False on batch 0: loss and "
        f"{len(grads[True]) - 1} gradients, max |d| / max|ref| {share:.3e} "
        f"(tol {TOL_BWD_BF16}); {same} of {len(grads[True])} bitwise equal")
    if not share <= TOL_BWD_BF16:
        fail("recompute changed the loss or a gradient")
    del grads, ids
    gc.collect()
    torch.cuda.empty_cache()
    tr = _trainer(model, batches, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    read = _reset_launches()
    tr.train()
    torch.cuda.synchronize()
    rc = read()
    rc_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    rc_losses = [v for _, v in tr.logger.history["loss"]]
    want_rc = dict(NO_LAUNCHES, flash=2 * L * 2, flash_bwd_dq=L * 2,
                   flash_bwd_dkv=L * 2, fused_adamw=2)
    log(f"[train] recompute=True (full), 2 steps: launches {rc} (want "
        f"{want_rc}); losses {rc_losses[0]:.4f}, {rc_losses[1]:.4f} (plain "
        f"run {losses[0]:.4f}, {losses[1]:.4f}); peak memory {rc_peak:.2f} GB"
        f" vs {peak_gb:.2f} GB without recompute [{card}]")
    if rc != want_rc:
        fail(f"recompute launches {rc} != {want_rc}")
    _check_routes("train recompute", flash=2 * L * 2, flash_bwd_dq=L * 2,
                  flash_bwd_dkv=L * 2)
    if not all(abs(a - r) <= TOL_BF16 * abs(r)
               for a, r in zip(rc_losses, losses[:2])):
        fail("recompute changed the loss of step 1 or 2")
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, routes


# ----------------------------------------------- the fused optimizer update
# tensors of the checks: Llama-3-8B projection shapes, a norm, and sizes
# that leave ragged tails (not multiples of 4 nor of the 2048-element chunk)
ADAM_CHECK_SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096,),
                     (4099, 7), (3,))
ADAM_HYPER = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8,
                  weight_decay=0.1, step=5)


def _adam_case(gen, dev, shapes, pdtype, gdtype, masters):
    """Parameters, gradients, masters, m and v from the generator, the
    state as after a few steps (m and v nonzero)."""
    ws = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    grads = [(torch.randn(s, generator=gen, device=dev) * 1e-2).to(gdtype)
             for s in shapes]
    ms = [torch.randn(s, generator=gen, device=dev) * 1e-3 for s in shapes]
    vs = [(torch.randn(s, generator=gen, device=dev) * 1e-3).square()
          for s in shapes]
    return ([w.to(pdtype) for w in ws], grads,
            [w.clone() for w in ws] if masters else None, ms, vs)


def _adam_clone(case):
    params, grads, masters, ms, vs = case
    return ([t.clone() for t in params], grads,
            None if masters is None else [t.clone() for t in masters],
            [t.clone() for t in ms], [t.clone() for t in vs])


def phase_adam_checks(gen, dev):
    """The fused update against its plain version on the card, on the same
    inputs: (a) bf16 parameters with fp32 masters, AdamW, a clip scale of
    0.37; (b) fp32 parameters without masters, Adam (L2 decay); (c) fp16
    parameters with masters and a GradScaler's inverse scale 2^-15 (fp16
    gradients scaled up by 2^15); decay on every other tensor; then (d)
    ``found_inf`` set: every byte of every tensor unchanged. Each case
    also repeats bit for bit. Returns the largest |d| of case (a)'s
    parameters and masters (the main path's case)."""
    from paddle_tpu_torch.ops.kernels.fused_adam import (
        fused_adam, fused_adam_reference)
    cases = {
        "a bf16 + fp32 masters, AdamW, clip 0.37": (
            torch.bfloat16, torch.bfloat16, True, True,
            dict(clip_scale=torch.tensor(0.37, device=dev))),
        "b fp32, no masters, Adam L2": (
            torch.float32, torch.float32, False, False, {}),
        "c fp16 + fp32 masters, AdamW, inv_scale 2^-15": (
            torch.float16, torch.float16, True, True,
            dict(inv_scale=torch.tensor(2.0 ** -15, device=dev))),
    }
    decay = [i % 2 == 0 for i in range(len(ADAM_CHECK_SHAPES))]
    main_err = None
    for label, (pd, gd, masters, decoupled, scalars) in cases.items():
        case = _adam_case(gen, dev, ADAM_CHECK_SHAPES, pd, gd, masters)
        if "inv_scale" in scalars:
            case = (case[0], [(g.float() * 2.0 ** 15).to(gd)
                              for g in case[1]]) + case[2:]
        kw = dict(ADAM_HYPER, decoupled=decoupled, **scalars)
        runs = [_adam_clone(case) for _ in range(3)]
        fused_adam(*runs[0], decay, **kw)
        fused_adam(*runs[1], decay, **kw)
        fused_adam_reference(*runs[2], decay, **kw)
        torch.cuda.synchronize()
        kern, again, plain = runs
        repeat = all(torch.equal(a, b) for a, b in zip(
            kern[0] + (kern[2] or []) + kern[3] + kern[4],
            again[0] + (again[2] or []) + again[3] + again[4]))
        worst, err = {}, 0.0
        groups = {"param": (kern[0], plain[0], pd),
                  "m": (kern[3], plain[3], torch.float32),
                  "v": (kern[4], plain[4], torch.float32)}
        if masters:
            groups["master"] = (kern[2], plain[2], torch.float32)
        for name, (got, want, dt) in groups.items():
            share = 0.0
            for a, b in zip(got, want):
                d = max_err(a, b)
                share = max(share, d / (TOL_ADAM[dt] * float(
                    b.float().abs().max()) + 1e-30))
                if name in ("param", "master"):
                    err = max(err, d)
            worst[name] = share
        log(f"[adam] {label}: max |d| / tol by tensor kind "
            + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
            + f" (tol {TOL_ADAM[pd]:.3g} x max|ref| for the "
            f"{str(pd).split('.')[1]} parameters, {TOL_ADAM[torch.float32]:.3g}"
            f" for fp32 state); max |d| of parameters and masters "
            f"{err:.3e}; repeat bitwise {repeat}")
        if max(worst.values()) > 1.0 or not repeat:
            fail(f"fused Adam {label}: disagrees with its plain version or "
                 f"does not repeat")
        if main_err is None:
            main_err = err
        del runs, case
    case = _adam_case(gen, dev, ADAM_CHECK_SHAPES, torch.bfloat16,
                      torch.bfloat16, True)
    before = _adam_clone(case)
    fused_adam(*case, decay, decoupled=True,
               inv_scale=torch.tensor(1.0, device=dev),
               found_inf=torch.tensor(True, device=dev), **ADAM_HYPER)
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(case[0] + case[2] + case[3] + case[4],
                               before[0] + before[2] + before[3]
                               + before[4]))
    log(f"[adam] d found_inf set: every byte unchanged {same}")
    if not same:
        fail("fused Adam wrote with found_inf set")
    return main_err


def phase_adam_times(seed, dev, card):
    """The fused update at the 4-layer training tensors (bf16 parameters
    of Llama-3-8B width, 4 layers): :func:`_adam_times`."""
    model = _train_model(seed, dev)
    row = _adam_times([p.detach() for p in model.parameters()], dev, card,
                      f"Llama-3-8B width, {TRAIN_LAYERS} layers", seed + 30,
                      note=f"; the per-tensor update before this kernel "
                           f"{ADAM_BEFORE_MS} ms")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _adam_times(params, dev, card, what, seed, note=""):
    """The fused update of ``params`` (bf16, with fp32 masters, AdamW, a
    clip scale; updated in place): the kernel, its plain version (tensor by tensor) and
    ``torch.optim.AdamW(fused=True)`` stepping fp32 copies with their own
    fp32 gradients (the same 28 bytes a parameter), in turns (kernel,
    plain, library, library, plain, kernel), CUDA events over 3 calls a
    turn; beside the bound from this run's parameter count."""
    import numpy as np

    from paddle_tpu_torch.ops.kernels.fused_adam import (
        fused_adam, fused_adam_reference)
    n = sum(p.numel() for p in params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = [(torch.randn(p.shape, generator=gen, device=dev) * 1e-3)
             .to(p.dtype) for p in params]
    masters = [p.float() for p in params]
    ms = [torch.zeros_like(m) for m in masters]
    vs = [torch.zeros_like(m) for m in masters]
    decay = [p.dim() > 1 for p in params]
    clip = torch.tensor(0.5, device=dev)
    cache = {}
    kw = dict(ADAM_HYPER, decoupled=True, clip_scale=clip)
    lib_params = [torch.nn.Parameter(m) for m in masters]
    for lp, g in zip(lib_params, grads):
        lp.grad = g.float()
    lib = torch.optim.AdamW(lib_params, lr=ADAM_HYPER["lr"],
                            betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                            fused=True)
    fns = {"kernel": lambda i: fused_adam(params, grads, masters, ms, vs,
                                          decay, cache=cache, **kw),
           "plain": lambda i: fused_adam_reference(params, grads, masters,
                                                   ms, vs, decay, **kw),
           "library": lambda i: lib.step()}
    times = {k: [] for k in fns}
    for name in ("kernel", "plain", "library", "library", "plain",
                 "kernel"):
        times[name].append(cuda_ms(fns[name], iters=3, warmup=1))
    el = {k: float(np.mean(v)) for k, v in times.items()}
    nbytes = sum(p.numel() * (p.element_size() + g.element_size() + 24)
                 for p, g in zip(params, grads))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ADAM_OPS * n / FP32_FLOP_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[adam] update of {n / 1e9:.4f} B parameters ({what}, "
        f"{len(params)} tensors, bf16 + fp32 masters, AdamW, clip): kernel "
        + ", ".join(f"{x:.3f}" for x in times["kernel"])
        + " ms; plain " + ", ".join(f"{x:.3f}" for x in times["plain"])
        + " ms; torch.optim.AdamW(fused=True) on fp32 copies "
        + ", ".join(f"{x:.3f}" for x in times["library"])
        + f" ms; bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB "
        f"at 3.35 TB/s) -> kernel at {100 * bound_ms / el['kernel']:.1f} % "
        f"of the bound{note} [{card}]")
    del params, grads, masters, ms, vs, lib, lib_params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ms=el["kernel"], plain_ms=el["plain"],
                library_ms=el["library"], bound_ms=bound_ms,
                bound_by=bound_by)


def _dir_gb(path) -> float:
    total = 0
    for root, _, names in os.walk(path):
        total += sum(os.path.getsize(os.path.join(root, n)) for n in names)
    return total / 1e9


def phase_resume(seed, dev, card):
    """Preempt and resume at full width with the depth cut to
    RESUME_LAYERS (a checkpoint of about 17.8 GB, written to this
    machine's disk): a DataLoader with a shuffled sampler, the Trainer at
    its defaults with save_steps=100, RESUME_STEPS steps uninterrupted;
    then a fresh run with ``faults.scoped("preempt@3")``, which must exit
    with SystemExit(76) after checkpointing step 3; then a fresh Trainer
    that resumes (the sampler restored in O(1)) to step RESUME_STEPS.
    Its final loss must be within TOL_RESUME of the uninterrupted run's;
    the counts of the resumed run (set to 0 just before it) must show
    its one step through the flash kernels and the fused update. The
    checkpoint directory is removed."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.io import DataLoader, RandomSampler, Subset
    from paddle_tpu_torch.utils import faults
    from paddle_tpu_torch.utils.shutdown import PREEMPTED_RC
    root = os.path.abspath("output/chip_smoke_resume")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    vocab = ptt.llama3_8b().vocab_size
    rows = np.random.RandomState(seed + 40).randint(
        0, vocab, (4 * TRAIN_BATCH[0], TRAIN_BATCH[1]))

    def run(out, preempt=None, timed=None):
        model = _train_model(seed, dev, layers=RESUME_LAYERS)
        ds = Subset(rows, list(range(len(rows))))
        dl = DataLoader(ds, batch_size=TRAIN_BATCH[0],
                        sampler=RandomSampler(ds, generator=seed + 41))
        tr = _trainer(model, dl, RESUME_STEPS, output_dir=out,
                      save_steps=100)
        if timed is not None:
            inner = tr._try_resume

            def resume(*a, **k):
                t0 = time.perf_counter()
                torch.cuda.synchronize()
                step = inner(*a, **k)
                torch.cuda.synchronize()
                timed["restore_s"] = time.perf_counter() - t0
                return step
            tr._try_resume = resume
        code = None
        if preempt is None:
            tr.train()
        else:
            with faults.scoped(preempt):
                try:
                    tr.train()
                except SystemExit as e:   # the preemption exit itself
                    code = e.code
        torch.cuda.synchronize()
        return tr, code

    ref, _ = run(os.path.join(root, "ref"))
    ref_losses = [v for _, v in ref.logger.history["loss"]]
    n_params = sum(p.numel() for p in ref.model.parameters())
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    out = os.path.join(root, "run")
    free0 = shutil.disk_usage(root).free / 1e9
    t0 = time.perf_counter()
    tr, code = run(out, preempt=f"preempt@{RESUME_PREEMPT}")
    preempt_s = time.perf_counter() - t0
    save = dict(tr._ckpt.last_save) if tr._ckpt is not None else {}
    step_dir = os.path.join(out, "checkpoints", str(RESUME_PREEMPT))
    gb = _dir_gb(step_dir) if os.path.isdir(step_dir) else 0.0
    layout = {}
    if os.path.isdir(step_dir):
        with open(os.path.join(step_dir, "index.json")) as f:
            layout["format"] = json.load(f).get("format")
        layout["pieces"] = sum(len(files) for _, _, files in
                               os.walk(os.path.join(step_dir, "r0")))
    free1 = shutil.disk_usage(root).free / 1e9
    stopped = tr.global_step
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[resume] Llama-3-8B width, {RESUME_LAYERS} layer(s) (depth cut "
        f"from 32 for the checkpoint's size on this machine's disk), "
        f"{n_params / 1e9:.3f} B params: preempt@{RESUME_PREEMPT} -> "
        f"SystemExit({code}) at step {stopped}; checkpoint of step "
        f"{RESUME_PREEMPT}: {gb:.2f} GB written in the per-rank layout "
        f"({layout.get('format')}: {layout.get('pieces')} piece files "
        f"under r0/, this rank's {save.get('bytes', 0) / 1e9:.2f} GB of "
        f"the state: at a world of one all of it), host copy "
        f"{save.get('snapshot_s', float('nan')):.2f} s + files, sha256 and "
        f"commit {save.get('write_s', float('nan')):.2f} s (the run "
        f"{preempt_s:.1f} s in all); free disk {free0:.1f} GB before, "
        f"{free1:.1f} GB after [{card}]")
    if code != PREEMPTED_RC or stopped != RESUME_PREEMPT or not gb or \
            not layout.get("pieces"):
        fail(f"resume: the preempted run exited {code} at step {stopped} "
             f"(want SystemExit({PREEMPTED_RC}) at step {RESUME_PREEMPT} "
             f"with a checkpoint)")

    timed = {}
    read = _reset_launches()
    tr, _ = run(out, timed=timed)
    launches = read()
    losses = [v for _, v in tr.logger.history["loss"]]
    final, ref_final = losses[-1], ref_losses[-1]
    L = RESUME_LAYERS
    steps = RESUME_STEPS - RESUME_PREEMPT
    want = dict(NO_LAUNCHES, flash=L * steps, flash_bwd_dq=L * steps,
                flash_bwd_dkv=L * steps, fused_adamw=steps)
    log(f"[resume] resumed from step {RESUME_PREEMPT} in "
        f"{timed.get('restore_s', float('nan')):.2f} s (verify sha256, "
        f"read, copy into the live tensors; files read "
        f"{tr._ckpt.last_restore.get('read_s', float('nan')):.2f} s), "
        f"sampler restored {tr._sampler_restored}, to step "
        f"{tr.global_step}: final loss {final:.6f} vs uninterrupted "
        f"{ref_final:.6f} (|d| {abs(final - ref_final):.2e}, tol "
        f"{TOL_RESUME}; bitwise {final == ref_final}); uninterrupted losses "
        + ", ".join(f"{x:.4f}" for x in ref_losses)
        + f"; launches {launches} (want {want}) [{card}]")
    ok = (tr._sampler_restored and tr.global_step == RESUME_STEPS
          and abs(final - ref_final) <= TOL_RESUME)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    log(f"[resume] phase {time.perf_counter() - t_phase:.1f} s; checkpoint "
        f"directory removed")
    if not ok:
        fail("resume: the resumed run did not end at the uninterrupted "
             "run's loss")
    if launches != want:
        fail(f"resume launches {launches} != {want}")
    _check_routes("resume", flash=L * steps, flash_bwd_dq=L * steps,
                  flash_bwd_dkv=L * steps)


def phase_fp16_train(seed, dev, card):
    """fp16 training: Llama-3-8B width, 4 layers, an fp16 model with fp32
    masters (AdamW through the fused update), a GradScaler at its
    defaults (2^15), FP16_STEPS steps over the phase-9 batches. A step
    is skipped when the scale falls; a skipped step must leave every
    parameter bit for bit as it was. The loss must be finite on the
    applied steps and fall; the flash forward, dq and dk/dv take their
    fp16 wgmma routes, once per layer and step (the counts set to 0 just
    before the run, read just after), the fused update once a step. Then
    a profiled step, and one step at a scale of 2^40, which must be
    skipped (its gradients overflow fp16) with every parameter kept."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.amp import GradScaler
    t_phase = time.perf_counter()
    model = _train_model(seed, dev, dtype=torch.float16)
    rs = np.random.RandomState(seed + 20)
    batches = [rs.randint(0, model.config.vocab_size, TRAIN_BATCH)
               for _ in range(2)]

    class Watch(ptt.TrainerCallback):
        """After each step: the scale, and whether a skipped step (scale
        fell) left the parameters as they were before it."""

        def __init__(self, tr):
            self.tr = tr
            self.rows = []
            self.kept = []
            self.t = [time.perf_counter()]
            self.scale = float(tr._scaler_state["scale"])
            self.snap = self._snap()

        def _snap(self):
            return [p.detach().clone() for p in self.tr.model.parameters()]

        def on_step_end(self, step, logs):
            self.t.append(time.perf_counter())
            scale = float(self.tr._scaler_state["scale"])
            skipped = scale < self.scale
            if skipped:
                self.kept.append(all(
                    torch.equal(a, b) for a, b in
                    zip(self.tr.model.parameters(), self.snap)))
            self.rows.append((step, logs["loss"], scale, skipped))
            self.scale = scale
            self.snap = self._snap()
            self.t[-1] = time.perf_counter()   # the snapshot is not step

    tr = _trainer(model, batches, FP16_STEPS, scaler=GradScaler(),
                  output_dir="output/chip_smoke_fp16")
    watch = Watch(tr)
    tr.callbacks.append(watch)
    torch.cuda.synchronize()
    read = _reset_launches()
    watch.t = [time.perf_counter()]
    tr.train()
    torch.cuda.synchronize()
    launches = read()
    L = model.config.num_hidden_layers
    want = dict(NO_LAUNCHES, flash=L * FP16_STEPS,
                flash_bwd_dq=L * FP16_STEPS, flash_bwd_dkv=L * FP16_STEPS,
                fused_adamw=FP16_STEPS)
    applied = [loss for _, loss, _, skipped in watch.rows if not skipped]
    skipped = [step for step, _, _, s in watch.rows if s]
    log(f"[fp16] Llama-3-8B width, {L} layers, fp16 + fp32 masters, "
        f"GradScaler defaults: step (loss, scale): "
        + ", ".join(f"{s} ({loss:.4f}, {sc:g})"
                    for s, loss, sc, _ in watch.rows)
        + f"; skipped steps {skipped} (parameters kept bit for bit: "
        f"{watch.kept}); launches {launches} (want {want})")
    # the step time without the callback's snapshots (the clock is
    # restarted after each)
    steps_ms = [(b - a) * 1e3 for a, b in zip(watch.t, watch.t[1:])]
    log(f"[fp16] step ms (host clock, loss synced; the parameter snapshot "
        f"of the check excluded): " + ", ".join(f"{x:.1f}" for x in steps_ms)
        + f"; median of steps 3-{FP16_STEPS} "
        f"{float(np.median(steps_ms[2:])):.1f} ms; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    if launches != want:
        fail(f"fp16 training launches {launches} != {want}")
    _check_routes("fp16 train", flash=L * FP16_STEPS,
                  flash_bwd_dq=L * FP16_STEPS, flash_bwd_dkv=L * FP16_STEPS)
    profile_train_step(tr, float(np.median(steps_ms[2:])), card,
                       label="fp16 train step (4 layers, [2,2048])")
    # one step at a scale of 2^40: the fp16 gradients of the logits
    # overflow, so the step must be skipped (the scale halves) and leave
    # every parameter as it was
    n_rows = len(watch.rows)
    tr._scaler_state["scale"].fill_(2.0 ** 40)
    watch.scale = 2.0 ** 40
    tr.train(max_steps=tr.global_step + 1)
    forced = watch.rows[n_rows:]
    log(f"[fp16] a step at scale 2^40: (step, loss, scale after, skipped) "
        f"{forced}; parameters kept bit for bit: {watch.kept}")
    if not (forced and forced[-1][3] and forced[-1][2] == 2.0 ** 39):
        fail(f"fp16: the step at scale 2^40 was not skipped: {forced}")
    if not watch.kept or not all(watch.kept):
        fail("fp16: a skipped step changed the parameters")
    if len(applied) < 2 or not all(np.isfinite(applied)) or \
            not applied[-1] < applied[0]:
        fail(f"fp16: the loss is not finite on the applied steps or did not "
             f"fall: {applied}")
    del tr, watch, model
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------- MoE phase
# ERNIE-4.5-21B-A3B's attention at the serving shapes: 20 query heads on
# 4 kv heads (GQA group 5), head_dim 128
MOE_FLASH = (4, 512, 20, 4, 128)        # b, s, h, kv, d
MOE_DECODE = (4, 576, 20, 4, 128)       # b, T, h, kv, d
MOE_RAGGED = dict(R=16, h=20, kvh=4)
# DeepSeek-V2-Lite's published config.json (the fields config_from_hf
# reads), its depth cut (MOE_CUTS)
DSV2_LITE = {
    "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048,
    "intermediate_size": 10944, "moe_intermediate_size": 1408,
    "num_hidden_layers": 8, "num_attention_heads": 16,
    "num_key_value_heads": 16, "n_shared_experts": 2,
    "n_routed_experts": 64, "num_experts_per_tok": 6,
    "first_k_dense_replace": 1, "kv_lora_rank": 512, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "topk_method": "greedy", "n_group": 1, "topk_group": 1,
    "routed_scaling_factor": 1.0, "norm_topk_prob": False,
    "moe_layer_freq": 1, "rope_theta": 10000, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 163840, "torch_dtype": "bfloat16",
    "tie_word_embeddings": False, "attention_bias": False,
    "rope_scaling": {"type": "yarn", "factor": 40, "beta_fast": 32,
                     "beta_slow": 1, "mscale": 0.707,
                     "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096}}
# the V3-style variant at the same widths: sigmoid scores, 8 groups of 8
# experts, the top-2-sum group score, 4 groups eligible, one MTP module
DSV3_VARIANT = dict(DSV2_LITE, model_type="deepseek_v3", n_group=8,
                    topk_group=4, norm_topk_prob=True)
# the MoE phase's depth cuts, for the script's time limit:
# DeepSeek-V2-Lite's widths (and the V3-style variant) at 8 of their 27
# layers; ERNIE-4.5-21B-A3B at 8 of its 28 (the tp-moe phase builds it,
# and its replica process draws it, at the same depth: replica_main
# --layers)
MOE_ERNIE_LAYERS = 8
MOE_CUTS = ("DeepSeek-V2-Lite's widths at 8 of 27 layers; "
            f"ERNIE-4.5-21B-A3B at {MOE_ERNIE_LAYERS} of 28 layers")


def _moe_kernel_checks(gen, dev, card):
    """The flash forward, decode and ragged kernels at ERNIE-4.5's head
    shape (group 5), bf16 and fp16, against their plain versions at the
    script's tolerances, each launch on its tensor-core route by count;
    then their bf16 times beside the plain versions, SDPA (heads
    pre-expanded) and the bound."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_fwd_plain)
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_plain)
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain)
    fb, fs, fh, fkv, fd = MOE_FLASH
    db, dT, dh, dkv, dd = MOE_DECODE
    R, rh, rkvh = MOE_RAGGED["R"], MOE_RAGGED["h"], MOE_RAGGED["kvh"]
    dec_ci = torch.tensor([dT - 1, 300, 64, 511], dtype=torch.int32,
                          device=dev)
    lens = ragged_lens(gen, dev, 1)

    def decode_case(dtype):
        return [(torch.randn(*s, generator=gen, device=dev)).to(dtype)
                for s in ((db, dh, dd), (db, dT, dkv, dd), (db, dT, dkv, dd))]

    def routed(fn, route, call):
        n = fn.launches_by_route[route]
        out = call()
        torch.cuda.synchronize()
        if fn.launches_by_route[route] != n + 1:
            fail(f"moe kernels: {fn.__name__} did not launch once on its "
                 f"{route} route at group 5")
        return out

    for dtype, tol in ((torch.bfloat16, TOL_BF16),
                       (torch.float16, TOL_FP16)):
        name = str(dtype).split(".")[-1]
        q, k, v = (t.to(dtype) for t in flash_inputs(gen, dev, *MOE_FLASH))
        out, lse = routed(flash_attention_fwd, "wgmma",
                          lambda: flash_attention_fwd(q, k, v, causal=True))
        ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal=True)
        e_f = max_err(out, ref)
        qd, ck, cv = decode_case(dtype)
        out = routed(decode_attention_fwd, "mma",
                     lambda: decode_attention_fwd(qd, ck, cv, dec_ci))
        e_d = max_err(out, decode_attention_fwd_plain(qd, ck, cv, dec_ci))
        case = paged_case(gen, dev, lens, dtype=dtype, h=rh, kvh=rkvh)
        out = routed(ragged_paged_attention, "mma",
                     lambda: ragged_paged_attention(*case))
        e_r = max_err(out, ragged_paged_attention_plain(*case))
        log(f"[moe] kernels at group 5, {name}: flash q {[fb, fs, fh, fd]} "
            f"kv {[fb, fs, fkv, fd]} causal max_abs_err {e_f:.3e} (lse "
            f"{max_err(lse, ref_lse):.3e}); decode q {[db, dh, dd]} cache "
            f"{[db, dT, dkv, dd]} at per-row device indices "
            f"{dec_ci.tolist()} {e_d:.3e}; ragged q {[R, rh, dd]} T 1, "
            f"pools [1025, 16, {rkvh}, {dd}] {e_r:.3e}; tol {tol}")
        if not (e_f <= tol and e_d <= tol and e_r <= tol):
            fail(f"moe kernels: a kernel disagrees with its plain version "
                 f"at group 5 in {name}")

    el = 2
    # flash at ERNIE's prefill shape
    call_bytes = el * (2 * fb * fs * fh * fd + 2 * fb * fs * fkv * fd) \
        + 4 * fb * fh * fs
    n = copies_for(call_bytes)
    sets = [flash_inputs(gen, dev, *MOE_FLASH) for _ in range(n)]
    lib = [tuple(t.transpose(1, 2).repeat_interleave(fh // t.shape[2], 1)
                 .contiguous() for t in qkv) for qkv in sets]
    times = {"flash": dict(
        ms=cuda_ms(lambda i: flash_attention_fwd(*sets[i % n], causal=True),
                   iters=40),
        plain_ms=cuda_ms(lambda i: flash_attention_fwd_plain(
            *sets[i % n], causal=True), iters=5),
        library_ms=cuda_ms(lambda i: TF.scaled_dot_product_attention(
            *lib[i % n], is_causal=True), iters=40),
        bound=bound(call_bytes, 4 * fd * fb * fh * fs * (fs + 1) // 2),
        shape=f"q {[fb, fs, fh, fd]} kv {[fb, fs, fkv, fd]} causal")}
    del sets, lib
    # decode at the per-row device indices
    valid = int((dec_ci + 1).sum())
    call_bytes = el * (2 * db * dh * dd + 2 * valid * dkv * dd)
    n = copies_for(call_bytes)
    sets = [decode_case(torch.bfloat16) for _ in range(n)]
    kpos = torch.arange(dT, device=dev)
    mask = (kpos[None, :] <= dec_ci[:, None].long())[:, None, None]
    lib = [(q[:, :, None], ck.transpose(1, 2).repeat_interleave(
        dh // dkv, 1).contiguous(), cv.transpose(1, 2).repeat_interleave(
        dh // dkv, 1).contiguous()) for q, ck, cv in sets]
    times["decode"] = dict(
        ms=graph_ms(lambda i: decode_attention_fwd(*sets[i % n], dec_ci),
                    calls=60),
        plain_ms=graph_ms(lambda i: decode_attention_fwd_plain(
            *sets[i % n], dec_ci), calls=10),
        library_ms=graph_ms(lambda i: TF.scaled_dot_product_attention(
            *lib[i % n], attn_mask=mask), calls=60),
        bound=bound(call_bytes, 4 * dd * dh * valid),
        shape=f"q {[db, dh, dd]} cache {[db, dT, dkv, dd]} at per-row "
              f"device indices {dec_ci.tolist()} (CUDA graph)")
    del sets, lib
    # ragged over the engine's pools, T = 1
    valid = int((torch.as_tensor(lens) + 1).sum())
    call_bytes = el * (2 * valid * rkvh * dd + 2 * R * rh * dd)
    n = copies_for(call_bytes)
    sets = [paged_case(gen, dev, lens, h=rh, kvh=rkvh) for _ in range(n)]
    lib, mask = sdpa_inputs(sets, torch.as_tensor(lens, device=dev))
    times["ragged"] = dict(
        ms=graph_ms(lambda i: ragged_paged_attention(*sets[i % n]),
                    calls=40),
        plain_ms=cuda_ms(lambda i: ragged_paged_attention_plain(
            *sets[i % n]), iters=20),
        library_ms=cuda_ms(lambda i: TF.scaled_dot_product_attention(
            *lib[i % n], attn_mask=mask), iters=100),
        bound=bound(call_bytes, 4 * dd * valid * rh),
        shape=f"q {[R, rh, dd]} T 1, pools [1025, 16, {rkvh}, {dd}], "
              f"seq_lens {sorted(lens)} (CUDA graph)")
    del sets, lib
    for key, t in times.items():
        t["bound_ms"], t["bound_by"] = t.pop("bound")
        log(f"[moe] time {key} at group 5, {t['shape']}: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}) [{card}]")


def _moe_split(prof):
    """Device ms of a profiled run by part: the attention kernels by name
    (launched from their wrappers, outside any torch op), the kernels of
    the ops inside the MoE layers' ``moe_experts`` and ``moe_route``
    profiler ranges (a kernel is charged to the op that launched it, the
    op to its innermost such range), and the rest of the device's
    time."""
    from torch.autograd import DeviceType
    attention = ("flash_fwd_", "decode_mma", "decode_simt", "ragged_")
    cats = dict.fromkeys(("expert_products", "routing_dispatch",
                          "attention_kernels", "rest"), 0.0)
    total = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            ms = e.time_range.elapsed_us() / 1e3
            total += ms
            if any(w in e.name.lower() for w in attention):
                cats["attention_kernels"] += ms
            continue
        if not e.kernels:
            continue
        part, p = None, e
        while p is not None and part is None:
            part = {"moe_experts": "expert_products",
                    "moe_route": "routing_dispatch"}.get(p.name)
            p = p.cpu_parent
        if part is not None:
            cats[part] += sum(k.duration for k in e.kernels) / 1e3
    cats["rest"] = total - sum(cats.values())
    return cats


def _moe_step_profile(ptt, pred, ids, step_ms, card, label):
    """One decode step's device time split (``_moe_split``) from the
    uncaptured step (the graph replays the same kernels, but a graph
    keeps no profiler ranges): generates of 1 and 9 new tokens under
    torch.profiler, the difference over 8 steps."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.generation import eager_steps
    per = {}
    for new in (1, 9):
        cfg = ptt.GenerationConfig(max_new_tokens=new)
        with eager_steps():
            pred.generate(ids, config=cfg)              # warm
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                pred.generate(ids, config=cfg)
                torch.cuda.synchronize()
        per[new] = _moe_split(prof)
    split = {k: (per[9][k] - per[1][k]) / 8 for k in per[9]}
    busy = sum(split.values())
    if busy <= 0:
        log(f"[moe] {label}: torch.profiler charged no kernel to an op: "
            f"the device-time split is not measured")
        return None
    log(f"[moe] {label} decode step device time (uncaptured step, "
        f"torch.profiler): {busy:.3f} ms, "
        + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f} %)"
                    for k, v in split.items())
        + f"; against the graphed step's {step_ms:.2f} ms: device busy "
        f"{100 * busy / step_ms:.1f} % [{card}]")
    return split


def _weights_read_per_step(model):
    """Bytes a decode step reads of the weights in the JAX design: every
    parameter (each expert multiplies its whole capacity bucket every
    step), the embedding table aside (one row a token)."""
    emb = model.model.embed_tokens.weight
    return sum(p.numel() * p.element_size() for p in model.parameters()
               if p is not emb)


def _moe_teacher(model, ids, out, new):
    """Re-run the greedy stream through the model's forward, teacher
    forced: the prompt's prefill into a fresh cache, then each emitted
    token a step at a device index (the shapes ``generate`` ran, so the
    same routing): every emitted token must be its step's argmax. Returns
    the largest gap below a step's maximum logit."""
    b, prompt = ids.shape
    caches = model.init_kv_caches(b, prompt + new)
    gap = 0.0
    with torch.inference_mode():
        logits, _ = model(ids, kv_caches=caches, cache_index=0)
        for t in range(new):
            row = logits[:, -1].float()
            tok = out[:, prompt + t]
            gap = max(gap, float((row.max(-1).values
                                  - row.gather(1, tok[:, None])[:, 0]).max()))
            if t + 1 < new:
                ci = torch.full((b,), prompt + t, dtype=torch.int32,
                                device=ids.device)
                logits, _ = model(tok[:, None], kv_caches=caches,
                                  cache_index=ci)
    return gap


def _moe_sync_free(model, dev):
    """An MoE layer's forward at the decode shape under the sync-debug
    mode "error": a host read on the routing path raises."""
    from paddle_tpu_torch.parallel.moe import MoEMLP
    mlp = next(m for m in model.modules() if isinstance(m, MoEMLP))
    x = torch.randn(4, 1, mlp.hidden_size, device=dev,
                    dtype=next(mlp.parameters()).dtype)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            mlp(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _moe_ernie(seed, dev, card):
    """ERNIE-4.5-21B-A3B at full width, its depth cut (``MOE_CUTS``),
    random bf16 weights drawn on the card: ``generate`` (graphed; against the uncaptured
    step; teacher forced), the decode step's split and bound, then the
    PagedEngine. Returns the launches of the main paths."""
    import numpy as np

    import paddle_tpu_torch as ptt
    t0 = time.perf_counter()
    cfg = ptt.models.Ernie45MoeConfig(num_hidden_layers=MOE_ERNIE_LAYERS)
    model = ptt.models.Ernie45MoeForCausalLM(
        cfg, device=dev, generator=ptt.make_generator(seed + 60, dev))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    L = cfg.num_hidden_layers
    log(f"[moe] ERNIE-4.5-21B-A3B (Ernie45MoeConfig() defaults, cut to {L} "
        f"of 28 layers, MOE_CUTS: "
        f"hidden {cfg.hidden_size}, heads {cfg.num_attention_heads}/"
        f"{cfg.num_key_value_heads}, {cfg.num_experts} experts top-"
        f"{cfg.num_experts_per_tok} of width {cfg.moe_intermediate_size}, "
        f"shared {cfg.shared_expert_intermediate_size}, layer 0 dense "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}, {cfg.dtype}): "
        f"{n_params / 1e9:.2f} B params, "
        f"{_weight_gb(model):.1f} GB, random init on the card in "
        f"{time.perf_counter() - t0:.1f} s; depth cuts: {MOE_CUTS}")
    _moe_sync_free(model, dev)
    log("[moe] an MoE layer's forward at the decode shape under "
        "torch.cuda.set_sync_debug_mode('error'): no host read")
    pred = ptt.Predictor(model, device=dev)
    b, prompt, new = 4, 512, 64
    ids = torch.randint(0, cfg.vocab_size, (b, prompt), device=dev,
                        generator=ptt.make_generator(seed + 61, dev))
    want = dict(NO_LAUNCHES, flash=L, decode=L * (new - 1))
    run = _generate_run(ptt, pred, ids, new, want, "moe", dev, card)
    gap = _moe_teacher(model, ids, run["out"], new)
    log(f"[moe] teacher-forced re-run of the greedy stream through the "
        f"model's forward (prefill, then one step a token at a device "
        f"index): largest gap below a step's maximum logit {gap:.4f} (tol "
        f"{TOL_TEACHER})")
    if gap > TOL_TEACHER:
        fail(f"moe: the greedy stream is not the teacher-forced argmax "
             f"(gap {gap:.4f})")
    nbytes = _weights_read_per_step(model)
    step_bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[moe] decode step {run['decode_ms']:.2f} ms graphed "
        f"({run['eager_ms']:.2f} uncaptured) against its bound "
        f"{step_bound:.2f} ms: every expert multiplies its capacity "
        f"bucket (C = 4) each step, so a step reads the {nbytes / 1e9:.1f} "
        f"GB of weights but the embedding table at 3.35 TB/s; prefill "
        f"{run['prefill_ms']:.1f} ms ({b} x {prompt}); peak memory "
        f"{run['peak_gb']:.2f} GB [{card}]")
    profile_decode_step(ptt, pred, ids, run["decode_ms"], card, "moe")
    _moe_step_profile(ptt, pred, ids, run["decode_ms"], card, "moe")
    launches = {k: run["launches"][k] for k in ("flash", "decode")}
    launches["ragged"], engine, tick_ms = _moe_engine(seed, dev, card, model)
    # what the tp-moe phase holds its sharded builds and its replica to:
    # this plain model's streams (it is freed before they are built)
    record = dict(ids=ids.cpu(), generate=run["out"].cpu(),
                  decode_ms=run["decode_ms"], engine=engine,
                  tick_ms=tick_ms, replica=_tp_moe_direct(seed, model))
    del pred, model, run
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record


def _moe_engine(seed, dev, card, model):
    """The PagedEngine on ERNIE at its defaults (graphed ticks), whole-
    prompt prefill, 16 greedy requests: ragged once per layer and tick on
    the mma route, never in a prefill; a steady tick timed and profiled.
    Returns the ragged launches, the streams (results, logprobs) and the
    steady tick's ms."""
    import numpy as np

    from paddle_tpu_torch.generation.paged import PagedEngine
    cfg = model.config
    L = cfg.num_hidden_layers
    subs, ids = _moe_engine_subs(seed, cfg.vocab_size)
    eng = PagedEngine(model, **PAGED)
    _serve(eng, subs[:1], late_after=0)                 # captures
    steps0 = eng.stats["decode_steps"]
    disp0 = eng.dispatch_count
    torch.cuda.reset_peak_memory_stats(dev)
    read = _reset_launches()
    out, wall, ttft, in_prefill = _serve(eng, subs, late_after=4)
    launches = read()
    ticks = eng.stats["decode_steps"] - steps0
    want = dict(NO_LAUNCHES, ragged=L * ticks)
    log(f"[moe] PagedEngine({PAGED}) on ERNIE-4.5-21B-A3B, 16 requests "
        f"(prompts 64-512, 64 new, greedy, whole-prompt prefill): "
        f"launches {launches} (want {want}; {in_prefill} inside "
        f"prefills); {eng.dispatch_count - disp0} dispatches for {ticks} "
        f"ticks and 16 prefills")
    if launches != want or in_prefill:
        fail(f"moe engine: launches {launches} != {want}")
    _check_routes("moe engine", ragged=L * ticks)
    if sorted(out) != sorted(r for r, _, _ in subs) or any(
            len(v) != 64 or not all(0 <= t < cfg.vocab_size for t in v)
            for v in out.values()):
        fail("moe engine: a request was lost, cut or gave ids outside the "
             "vocabulary")
    t = np.array(list(ttft.values()))
    log(f"[moe] engine: {16 * 64} new tokens in {ticks} ticks, {wall:.2f} "
        f"s, {16 * 64 / wall:.1f} new tokens/s, TTFT median "
        f"{np.median(t):.1f} ms p99 {np.percentile(t, 99):.1f} ms, peak "
        f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, graph "
        f"pool {eng.graph_pool_bytes / 1e6:.1f} MB [{card}]")
    # every row of a tick routes, idle ones too, against the live rows'
    # capacity: idle rows' colliding garbage-block writes carry one value
    # (paged_decode_write), so a rerun and the host tick must give the
    # same tokens and logprobs bit for bit
    lps = dict(eng.logprobs)
    again, _, _, _ = _serve(eng, subs, late_after=4)
    _same_streams("moe engine rerun", again, dict(eng.logprobs), out, lps)
    host = PagedEngine(model, fused_tick=False, **PAGED)
    ref, _, _, _ = _serve(host, subs, late_after=4)
    _same_streams("moe engine", out, lps, ref, dict(host.logprobs))
    del host
    log("[moe] engine streams: a rerun and the host tick "
        "(fused_tick=False) give identical tokens and logprobs")
    prof = profile_paged_tick(eng, ids, card, ticks=8, label="moe paged",
                              expect={"ragged_": L})
    if prof is not None:
        step_bound = _weights_read_per_step(model) / HBM_BYTES_PER_S * 1e3
        log(f"[moe] steady tick {prof['tick_ms']:.2f} ms graphed against "
            f"the weights' bound {step_bound:.2f} ms (16 rows: C = 4, every "
            f"expert multiplies) [{card}]")
    tick_ms = _steady_tick_ms(eng, ids)
    del eng
    return launches["ragged"], (out, lps), tick_ms


def _moe_engine_subs(seed, vocab):
    """The MoE engine phases' 16 greedy requests (prompts 64-512, 64 new)
    and the token drawer they came from."""
    import numpy as np
    rs = np.random.RandomState(seed + 62)
    gen = torch.Generator().manual_seed(seed + 63)

    def ids(n):
        return torch.randint(0, vocab, (n,), generator=gen)

    return [(f"m{i}", ids(int(rs.randint(64, 513))),
             dict(max_new_tokens=64)) for i in range(16)], ids


def _steady_tick_ms(eng, ids):
    """Mean ms of 16 steady ticks with every slot holding a 256-token
    request, then the requests run out."""
    _fill(eng, ids, 32)
    ms = _timed_ticks(eng, 16)
    eng.run()
    return ms


def _deepseek_build(hf, seed, dev, **over):
    """A DeepSeek model of the HF config ``hf`` through ``config_from_hf``
    (fields ``over`` replaced), drawn on ``dev`` from ``seed``: (model,
    config, model type, seconds). Inside ``sharded_build`` each decoder
    layer is cut to this rank's shards as it is drawn."""
    import dataclasses

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.hf_interop import config_from_hf
    d = tempfile.mkdtemp(prefix="chip_smoke_dsv2_")
    try:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf, f)
        cls, cfg, mt = config_from_hf(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    cfg = dataclasses.replace(cfg, **over)
    t0 = time.perf_counter()
    model = cls(cfg, device=dev, generator=ptt.make_generator(seed, dev))
    torch.cuda.synchronize()
    return model, cfg, mt, time.perf_counter() - t0


def _moe_deepseek(seed, dev, card):
    """DeepSeek-V2-Lite's widths through ``config_from_hf`` and
    ``generate`` (graphed; MLA reaches no kernel of the port), then the
    V3-style variant through ``mtp_speculative_generate``."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.generation import eager_steps
    from paddle_tpu_torch.generation.speculative import \
        mtp_speculative_generate
    b, prompt, new = 4, 512, 64

    def build(hf, seed_, **over):
        return _deepseek_build(hf, seed_, dev, **over)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    model, cfg, mt, build_s = build(DSV2_LITE, seed + 70)
    L = cfg.num_hidden_layers
    n_params = sum(p.numel() for p in model.parameters())
    mla = (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * L * 2
    kv = 2 * cfg.num_attention_heads * cfg.v_head_dim * L * 2
    heads, width = cfg.num_attention_heads, cfg.moe_intermediate_size
    log(f"[moe] DeepSeek-V2-Lite widths through config_from_hf "
        f"({mt}: {L} layers, hidden {cfg.hidden_size}, {heads} heads, "
        f"kv_lora_rank {cfg.kv_lora_rank}, q_lora_rank "
        f"{cfg.q_lora_rank}, qk {cfg.qk_nope_head_dim}+"
        f"{cfg.qk_rope_head_dim}, v {cfg.v_head_dim}, {cfg.num_experts} "
        f"experts top-{cfg.num_experts_per_tok} of {width}, "
        f"{cfg.num_shared_experts} shared, layer 0 dense "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}, yarn "
        f"{cfg.rope_scaling['factor']}): {n_params / 1e9:.2f} B params, "
        f"{_weight_gb(model):.1f} GB, random init on the card in "
        f"{build_s:.1f} s; MLA cache {mla} B a token against {kv} B for a "
        f"(k, v) cache of its heads ({kv / mla:.1f}x); depth cuts: "
        f"{MOE_CUTS}")
    ids = torch.randint(0, cfg.vocab_size, (b, prompt), device=dev,
                        generator=ptt.make_generator(seed + 71, dev))
    gcfg = ptt.GenerationConfig(max_new_tokens=new)
    one = ptt.GenerationConfig(max_new_tokens=1)
    ptt.generate(model, ids, gcfg)                      # warm: captures
    ptt.generate(model, ids, one)
    _, prefill_ms = timed(lambda: ptt.generate(model, ids, one))
    torch.cuda.reset_peak_memory_stats(dev)
    read = _reset_launches()
    out, total_ms = timed(lambda: ptt.generate(model, ids, gcfg))
    launches = read()
    if launches != NO_LAUNCHES:
        fail(f"deepseek generate: launches {launches} (MLA reaches no "
             f"kernel of the port)")
    with eager_steps():
        ref, eager_ms = timed(lambda: ptt.generate(model, ids, gcfg))
    if not torch.equal(out, ref):
        fail("deepseek: the graphed greedy stream differs from the "
             "uncaptured step's")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        fail("deepseek: ids outside the vocabulary")
    gap = _moe_teacher(model, ids, out, new)
    if gap > TOL_TEACHER:
        fail(f"deepseek: the greedy stream is not the teacher-forced "
             f"argmax (gap {gap:.4f})")
    step_ms = (total_ms - prefill_ms) / (new - 1)
    step_bound = _weights_read_per_step(model) / HBM_BYTES_PER_S * 1e3
    log(f"[moe] DeepSeek-V2-Lite generate {b} x {prompt} + {new}: prefill "
        f"{prefill_ms:.1f} ms, decode {step_ms:.2f} ms a step graphed "
        f"({(eager_ms - prefill_ms) / (new - 1):.2f} uncaptured, the "
        f"streams bit for bit) against its weights' bound {step_bound:.2f} "
        f"ms, teacher-forced gap {gap:.4f}, launches {launches} (the "
        f"absorbed decode is torch einsums, as in the JAX package), peak "
        f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
        f"[{card}]")
    record = dict(ids=ids.cpu(), v2_generate=out.cpu())
    del model, out, ref
    gc.collect()
    torch.cuda.empty_cache()

    model, cfg, mt, build_s = build(DSV3_VARIANT, seed + 72,
                                    num_nextn_predict_layers=1)
    rows = 2
    kw = dict(max_new_tokens=new, num_draft_tokens=4, return_stats=True)
    mtp_speculative_generate(model, ids[:rows], **kw)   # warm: captures
    (out, stats), ms = timed(
        lambda: mtp_speculative_generate(model, ids[:rows], **kw))
    with eager_steps():
        ref, _ = mtp_speculative_generate(model, ids[:rows],
                                          **dict(kw, max_new_tokens=16))
    short, _ = mtp_speculative_generate(model, ids[:rows],
                                        **dict(kw, max_new_tokens=16))
    if not torch.equal(short, ref):
        fail("mtp: the graphed iteration's stream differs from the "
             "uncaptured one's")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        fail("mtp: ids outside the vocabulary")
    log(f"[moe] V3-style variant at the same widths ({mt} through "
        f"config_from_hf: sigmoid scores, {cfg.n_group} groups, top-"
        f"{cfg.topk_group} by {cfg.group_score_mode}, norm_topk_prob; one "
        f"MTP module; {sum(p.numel() for p in model.parameters()) / 1e9:.2f}"
        f" B params) through mtp_speculative_generate, {rows} x {prompt} + "
        f"{new}, 4 drafts a round, rows decoded one at a time (MoE): "
        f"{ms:.1f} ms, target forwards {stats['target_forwards']}, tokens "
        f"per forward {[round(x, 3) for x in stats['tokens_per_forward']]}"
        f" (random weights: says nothing of a trained model's accept "
        f"rate); graphed bit for bit uncaptured at 16 new [{card}]")
    record.update(v3_mtp=out.cpu(), v3_forwards=stats["target_forwards"])
    del model, out
    gc.collect()
    torch.cuda.empty_cache()
    return record


def phase_moe(seed, dev, card):
    """The MoE families (``[moe]`` lines): the kernels at ERNIE's shapes,
    ERNIE-4.5-21B-A3B through ``generate`` and the PagedEngine,
    DeepSeek-V2-Lite's widths through ``generate``, the V3-style variant
    through ``mtp_speculative_generate``. Returns the main paths'
    launches of flash, decode and ragged, and the plain models' streams
    the ``tp-moe`` phase holds its sharded builds to."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 50)
    _moe_kernel_checks(gen, dev, card)
    launches, record = _moe_ernie(seed, dev, card)
    record["deepseek"] = _moe_deepseek(seed, dev, card)
    log(f"[moe] phase {time.perf_counter() - t0:.1f} s")
    return launches, record


def _lse_case(gen, dev, b, s, h, kv, d):
    """bf16 q, k, v, dout and a nonzero fp32 lse cotangent."""
    q, k, v, g, _ = _bwd_inputs(gen, dev, torch.bfloat16, b, s, h, kv, d)
    g_lse = torch.randn(b, h, s, generator=gen, device=dev) * 0.5
    return q, k, v, g, g_lse


def _parallel_lse(gen, dev, card):
    """(a) flash_attention_with_lse at the ring's block shape against its
    plain twin, causal and not: out and lse of the forward, dq, dk, dv of
    the backward with a random nonzero lse cotangent (the kernels with the
    cotangent folded into delta against the dense terms), each repeated
    bit for bit; the autograd Function against the direct calls. Then its
    times at the block (non-causal: the ring's past blocks), forward and
    backward, beside the plain twin, SDPA (forward only: it returns no
    lse) and the bounds. Returns (max_abs_err, time row)."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    b, s, h, kv, d = RING_BLOCK
    worst = 0.0
    for causal in (True, False):
        q, k, v, g, g_lse = _lse_case(gen, dev, b, s, h, kv, d)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        got = fa.flash_attention_with_lse_bwd(q, k, v, out, lse, g, g_lse,
                                              causal=causal)
        again = fa.flash_attention_with_lse_bwd(q, k, v, out, lse, g, g_lse,
                                                causal=causal)
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        fo, fl = fa.flash_attention_with_lse(*xs, causal=causal)
        fg = torch.autograd.grad([fo, fl], xs, [g, g_lse])
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v,
                                                        causal=causal)
        ref = fa.flash_attention_with_lse_bwd_plain(q, k, v, out, lse, g,
                                                    g_lse, causal=causal)
        err, lse_err = max_err(out, ref_out), max_err(lse, ref_lse)
        out_d = (out.float() - ref_out.float()).abs()
        out_max = float(ref_out.float().abs().max())
        out_tol = (TOL_LSE_OUT_REL * ref_out.float().abs()
                   + TOL_LSE_OUT_ABS * out_max)
        out_share = float((out_d / out_tol).max())
        line = [f"out {err:.3e} (max|ref| {out_max:.3e}, {out_share:.3f} "
                f"of its bound at worst)", f"lse {lse_err:.3e}"]
        ok = out_share <= 1.0 and lse_err <= 1e-2
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            e, rmax = max_err(a, r), float(r.float().abs().max())
            line.append(f"{name} {e:.3e} (max|ref| {rmax:.3e})")
            ok = ok and e <= TOL_BWD_BF16 * rmax
            worst = max(worst, e)
        # the fold alone: with dout = 0 the kernels' dq and dk are the lse
        # cotangent's share (ds = p g_lse scale) and dv is 0, against the
        # dense lse_grad_terms in fp32
        zero = torch.zeros_like(g)
        fq, fk, fv = fa.flash_attention_with_lse_bwd(
            q, k, v, out, lse, zero, g_lse, causal=causal)
        rq, rk = fa.lse_grad_terms(q, k, lse, g_lse, causal=causal)
        for name, a, r in (("dq", fq, rq), ("dk", fk, rk)):
            e, rmax = max_err(a, r), float(r.abs().max())
            line.append(f"fold-only {name} {e:.3e} (max|ref| {rmax:.3e})")
            ok = ok and e <= TOL_BWD_BF16 * rmax
        fold_dv = float(fv.float().abs().max())
        line.append(f"fold-only max|dv| {fold_dv:.1e}")
        ok = ok and fold_dv == 0.0
        del zero, fq, fk, fv, rq, rk
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        func = (torch.equal(fo, out) and torch.equal(fl, lse)
                and all(torch.equal(x, y) for x, y in zip(fg, got)))
        log(f"[parallel] (a) flash_attention_with_lse bf16 "
            f"{'causal' if causal else 'non-causal'} q {[b, s, h, d]} kv "
            f"{[b, s, kv, d]}, lse cotangent folded into delta, against the "
            f"dense twin: " + ", ".join(line) + f" (tol out "
            f"{TOL_LSE_OUT_REL} |ref| + {TOL_LSE_OUT_ABS} max|ref|, lse "
            f"1e-2, grads {TOL_BWD_BF16} x max|ref|, fold-only dv 0); "
            f"bitwise repeat {same}; autograd Function = direct calls "
            f"{func}")
        if not (ok and same and func):
            fail(f"flash_attention_with_lse disagrees with its twin, does "
                 f"not repeat, or its Function differs (causal={causal})")
        worst = max(worst, err)
    # times at the block, non-causal, inputs rotated past the L2
    el = 2
    fwd_bytes = el * (2 * b * s * h * d + 2 * b * s * kv * d) + 4 * b * h * s
    n = copies_for(fwd_bytes)
    sets = [_lse_case(gen, dev, b, s, h, kv, d) for _ in range(n)]
    outs = [fa.flash_attention_fwd(q, k, v) for q, k, v, _, _ in sets]
    lib_sets = [tuple(t.transpose(1, 2).repeat_interleave(h // t.shape[2], 1)
                      .contiguous() for t in x[:3]) for x in sets]
    ms = cuda_ms(lambda i: fa.flash_attention_with_lse(*sets[i % n][:3]),
                 iters=40)
    plain_ms = cuda_ms(lambda i: fa.flash_attention_fwd_plain(
        *sets[i % n][:3]), iters=5)
    lib_ms = cuda_ms(lambda i: TF.scaled_dot_product_attention(
        *lib_sets[i % n]), iters=40)
    prod = 2 * d * b * h * s * s
    bound_ms, bound_by = bound(fwd_bytes, 2 * prod)

    def bwd(i):
        q, k, v, g, gl = sets[i % n]
        o, l = outs[i % n]
        return fa.flash_attention_with_lse_bwd(q, k, v, o, l, g, gl)

    def bwd_plain(i):
        q, k, v, g, gl = sets[i % n]
        o, l = outs[i % n]
        return fa.flash_attention_with_lse_bwd_plain(q, k, v, o, l, g, gl)
    bwd_ms = cuda_ms(bwd, iters=20)
    bwd_plain_ms = cuda_ms(bwd_plain, iters=3, warmup=1)
    # the backward reads q, k, v, out, dout, lse, the cotangent and writes
    # dq, dk, dv; 5 products (s, dp, dq, dk, dv) per pair
    bwd_bytes = el * (4 * b * s * h * d + 4 * b * s * kv * d) \
        + 8 * b * h * s
    bwd_bound, bwd_by = bound(bwd_bytes, 5 * prod)
    log(f"[time] flash_attention_with_lse at q {[b, s, h, d]} kv "
        f"{[b, s, kv, d]} bf16 non-causal: forward {ms:.4f} ms (bound "
        f"{bound_ms:.4f} ms by {bound_by}; plain twin {plain_ms:.4f} ms; "
        f"sdpa forward, no lse, {lib_ms:.4f} ms); backward with the lse "
        f"cotangent folded into the dq and dk/dv kernels {bwd_ms:.4f} ms "
        f"(bound {bwd_bound:.4f} ms by {bwd_by}; the dense twin "
        f"{bwd_plain_ms:.4f} ms) [{card}]")
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    del sets, outs, lib_sets
    return worst, row


def _parallel_ring(gen, dev, card):
    """(b) The ring's block math at full width on one card: a causal
    sequence of RING_SP x 2048 positions (heads 32/8, d 128, bf16); for
    each sp index, the exact sequence of ``ring_flash_step`` calls (the
    diagonal block causal, every past block whole, merged by lse) that
    ``ring_flash_attention`` runs on that rank, over the block the ring
    hands it at each step; out and the gradients of q, k, v against one
    ``flash_attention`` over all the positions. The counts are set to 0
    just before the ring's forward and backward and read just after:
    flash_attention_with_lse once per block pair a rank takes (10 at sp
    4), its backward as often. Returns (launches, routes)."""
    import math

    from paddle_tpu_torch.ops.attention import flash_attention
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_with_lse, flash_attention_with_lse_bwd)
    from paddle_tpu_torch.parallel.ring import ring_flash_step
    n = RING_SP
    b, sb, h, kv, d = RING_BLOCK
    S = n * sb
    q, k, v, g, _ = _bwd_inputs(gen, dev, torch.bfloat16, b, S, h, kv, d)
    scale = 1.0 / math.sqrt(d)

    def ring(q, k, v, only=None):
        outs = []
        for idx in range(n) if only is None else [only]:
            blk = lambda t, j: t[:, j * sb:(j + 1) * sb].contiguous()  # noqa: E731,E501
            o, lse, _ = ring_flash_step(blk(q, idx), blk(k, idx),
                                        blk(v, idx), None, None, 0, idx,
                                        True, scale)
            for step in range(1, n):
                j = (idx - step) % n     # the block the ring holds now
                o, lse, _ = ring_flash_step(blk(q, idx), blk(k, j),
                                            blk(v, j), o, lse, step, idx,
                                            True, scale)
            outs.append(o.to(q.dtype))
        return torch.cat(outs, dim=1) if only is None else outs[0]

    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    torch.cuda.synchronize()
    read = _reset_launches()
    out = ring(*xs)
    grads = torch.autograd.grad(out, xs, g)
    torch.cuda.synchronize()
    launches = read()
    pairs = n * (n + 1) // 2
    want = dict(NO_LAUNCHES, flash_lse=pairs, flash_lse_bwd=pairs,
                flash=pairs, flash_bwd_dq=pairs, flash_bwd_dkv=pairs)
    log(f"[parallel] (b) ring launches (sp {n}, causal): {launches} (want "
        f"{want})")
    if launches != want:
        fail(f"ring launches {launches} != {want}")
    routes = _check_routes("parallel", flash=pairs, flash_bwd_dq=pairs,
                           flash_bwd_dkv=pairs)
    routes["flash_lse"] = dict(flash_attention_with_lse.launches_by_route)
    routes["flash_lse_bwd"] = dict(
        flash_attention_with_lse_bwd.launches_by_route)
    ys = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = flash_attention(*ys, causal=True)
    ref_grads = torch.autograd.grad(ref, ys, g)
    torch.cuda.synchronize()
    line, ok = [], True
    for name, a, r in zip(("out", "dq", "dk", "dv"),
                          (out.detach(),) + grads,
                          (ref.detach(),) + ref_grads):
        e, rmax = max_err(a, r), float(r.float().abs().max())
        line.append(f"{name} {e:.3e} (max|ref| {rmax:.3e})")
        ok = ok and e <= TOL_BWD_BF16 * rmax
    log(f"[parallel] (b) ring of {n} x {sb} at Llama-3-8B width (q "
        f"{[b, S, h, d]}, kv {[b, S, kv, d]}, bf16, causal) against one "
        f"flash_attention over {S} positions: " + ", ".join(line)
        + f" (tol {TOL_BWD_BF16} x max|ref|)")
    if not ok:
        fail("the ring's block math disagrees with one flash attention")

    # times: each rank's share (forward + backward of its block pairs)
    # against the single flash call over all positions
    def rank_step(idx):
        zs = [t.detach().requires_grad_() for t in (q, k, v)]
        o = ring(*zs, only=idx)
        torch.autograd.grad(o, zs, g[:, idx * sb:(idx + 1) * sb])

    def whole(_):
        zs = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(flash_attention(*zs, causal=True), zs, g)
    per_rank = [cuda_ms(lambda i, r=r: rank_step(r), iters=5)
                for r in range(n)]
    whole_ms = cuda_ms(whole, iters=5)
    log(f"[time] ring forward + backward per sp rank (sp {n}, block {sb}, "
        f"causal; rank r takes r + 1 block pairs): "
        + ", ".join(f"rank {r} {t:.3f} ms" for r, t in enumerate(per_rank))
        + f"; one flash_attention forward + backward over {S} positions "
        f"{whole_ms:.3f} ms (its 1/{n} share {whole_ms / n:.3f} ms; the "
        f"slowest rank at {max(per_rank) / (whole_ms / n):.2f} x that "
        f"share) [{card}]")
    return launches, routes


def _parallel_mesh(seed, dev, card):
    """(c) The mesh path on NCCL with a world of one: ``fleet.init`` with
    every degree 1, ``fleet.distributed_model`` (DTensor parameters), then
    the Trainer, PR 13's 4-layer Llama-3-8B-width config for
    PARALLEL_STEPS steps; its losses bit for bit the plain Trainer's on
    the same seed and batches, and the flash forward, dq, dk/dv and the
    fused update launched on the mesh run as on the plain one. Both step
    times (DTensor's host cost is their difference)."""
    import gc

    import numpy as np
    import torch.distributed as dist

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import env, fleet
    from paddle_tpu_torch.parallel.sharding import is_sharded

    class StepClock(ptt.TrainerCallback):
        def __init__(self):
            self.t = []

        def on_step_end(self, step, logs):
            self.t.append(time.perf_counter())

    rs = np.random.RandomState(seed + 20)
    batches = [rs.randint(0, 128256, TRAIN_BATCH) for _ in range(2)]
    runs = {}
    for arm in ("plain", "mesh"):
        model = _train_model(seed, dev)
        if arm == "mesh":
            st = fleet.DistributedStrategy(hybrid_configs={})
            fleet.init(strategy=st)
            mesh = env.get_mesh()
            fleet.distributed_model(model)
            sharded = sum(is_sharded(p) for p in model.parameters())
            log(f"[parallel] (c) mesh {mesh.shape} on {mesh.device}, "
                f"backend {dist.get_backend()}, world "
                f"{dist.get_world_size()}; {sharded} of "
                f"{len(list(model.parameters()))} parameters are DTensors")
        clock = StepClock()
        tr = _trainer(model, batches, PARALLEL_STEPS, clock,
                      output_dir=f"output/chip_smoke_parallel_{arm}")
        torch.cuda.synchronize()
        read = _reset_launches()
        clock.t = [time.perf_counter()]
        tr.train()
        torch.cuda.synchronize()
        launches = read()
        steps_ms = np.diff(clock.t) * 1e3
        runs[arm] = dict(losses=[v for _, v in tr.logger.history["loss"]],
                         launches=launches,
                         step_ms=float(np.median(steps_ms[1:])))
        del tr, model
        gc.collect()
        torch.cuda.empty_cache()
    L = TRAIN_LAYERS
    want = dict(NO_LAUNCHES, flash=L * PARALLEL_STEPS,
                flash_bwd_dq=L * PARALLEL_STEPS,
                flash_bwd_dkv=L * PARALLEL_STEPS, fused_adamw=PARALLEL_STEPS)
    a, m = runs["plain"], runs["mesh"]
    same = a["losses"] == m["losses"]
    log(f"[parallel] (c) losses plain: "
        + ", ".join(f"{x:.6f}" for x in a["losses"]) + "; mesh: "
        + ", ".join(f"{x:.6f}" for x in m["losses"])
        + f"; bit for bit {same}; launches plain {a['launches']}, mesh "
        f"{m['launches']} (want {want})")
    log(f"[time] (c) Trainer step, 4 layers [2, 2048], median of steps "
        f"2-{PARALLEL_STEPS}: plain {a['step_ms']:.1f} ms, on the "
        f"world-one mesh (DTensor parameters) {m['step_ms']:.1f} ms: "
        f"DTensor's host cost {m['step_ms'] - a['step_ms']:.1f} ms a step "
        f"[{card}]")
    if not same:
        fail("the mesh Trainer's losses differ from the plain Trainer's")
    if a["launches"] != want or m["launches"] != want:
        fail("the mesh or plain Trainer launched other kernels than "
             f"{want}")
    env.clear_mesh()
    dist.destroy_process_group()
    for arm in runs:
        shutil.rmtree(f"output/chip_smoke_parallel_{arm}",
                      ignore_errors=True)


def phase_parallel(seed, gen, dev, card):
    """The multi-device slice on one card (``[parallel]`` lines): (a)
    flash_attention_with_lse against its twin, (b) the ring's block math
    at full width (its launches are the kernels line's), (c) the mesh
    path through NCCL at a world of one. Returns (errors, times,
    launches, routes) for the kernels line."""
    err, row = _parallel_lse(gen, dev, card)
    launches, routes = _parallel_ring(gen, dev, card)
    _parallel_mesh(seed, dev, card)
    return err, row, launches, routes


# phase 13: an MoE model through the Trainer, and the pipeline schedules
MOE_TRAIN_LAYERS = 3          # ERNIE-4.5-21B-A3B cut: 1 dense + 2 MoE
MOE_TRAIN_BATCH = (2, 2048)
MOE_TRAIN_STEPS = 5
MOE_TRAIN_ATTN = (2, 2048, 20, 4, 128)  # b, s, h, kv, d of its attention
# bf16 gradients on two routes of the same weights (relative L2)
TOL_GRAD_REL = 2e-2
# state a parameter: bf16 weight and gradient, fp32 master, m and v
STATE_BYTES_PER_PARAM = 16
MIN_FREE_GB = 15.0
PP_LAYERS = 4
PP_MICRO = (4, 1, 2048)       # M microbatches of [1, 2048]


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _moe_drop_hooks(model):
    """Forward pre-hooks that record each MoE layer's (dropped, routed)
    choices of the call, through the layer's own routing."""
    from paddle_tpu_torch.parallel.moe import MoEMLP, _route
    seen = []

    def hook(mod, args):
        with torch.no_grad():
            x = args[0].reshape(-1, mod.hidden_size)
            logits = x.float() @ mod.gate.float()
            _, _, keep, _, _ = _route(
                logits, mod.top_k, mod.capacity(x.shape[0]),
                bias=mod.expert_bias, norm_topk_prob=mod.norm_topk_prob,
                n_group=mod.n_group, topk_group=mod.topk_group,
                scoring=mod.scoring, group_score_mode=mod.group_score_mode)
            seen.append((int((~keep).sum()), keep.numel()))
    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, MoEMLP)]
    return seen, handles


def _moe_attn_check(seed, dev):
    """The flash forward, dq and dk/dv kernels at the shape (a)'s train
    step gives them (MOE_TRAIN_ATTN: ERNIE-4.5's 20 query heads on 4 kv
    heads, GQA group 5, d 128, [2, 2048], causal, bf16) against their
    plain versions on the same inputs: the output within TOL_BF16,
    dq, dk and dv within TOL_BWD_BF16 x max|ref|, each kernel launched
    once on its wgmma route."""
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 75)
    q, k, v, g, _ = _bwd_inputs(gen, dev, torch.bfloat16, *MOE_TRAIN_ATTN)
    _reset_launches()
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    got = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    torch.cuda.synchronize()
    _check_routes("moe-train check", flash=1, flash_bwd_dq=1,
                  flash_bwd_dkv=1)
    ref_out, _ = flash_attention_fwd_plain(q, k, v, causal=True)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True)
    errs = {"out": (max_err(out, ref_out), TOL_BF16)}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        rmax = float(r.float().abs().max())
        errs[name] = (max_err(a, r), TOL_BWD_BF16 * rmax)
    b, s, h, kv, d = MOE_TRAIN_ATTN
    log(f"[moe-train] flash at the train step's shape, q {[b, s, h, d]} kv "
        f"{[b, s, kv, d]} (group {h // kv}), causal, bf16, against the "
        f"plain versions: " + ", ".join(
            f"{n} {e:.3e} (tol {t:.3e})" for n, (e, t) in errs.items()))
    for name, (e, t) in errs.items():
        if not e <= t:
            fail(f"moe-train: flash {name} at group {h // kv} disagrees with "
                 f"its plain version: {e:.3e} > {t:.3e}")
    del q, k, v, g, out, lse, got, ref, ref_out


def _moe_grad_routes(seed, dev, card):
    """(a) at a small width: an ERNIE-shaped MoE model (2 layers, hidden
    256, bf16) whose gradients through the flash kernels must be within
    TOL_GRAD_REL (relative L2, each parameter) of the same weights'
    gradients through the kernels' plain twins on the card (the forward
    and backward of ``FlashAttentionFunction`` pointed at
    ``flash_attention_fwd_plain`` / ``flash_attention_bwd_plain``, which
    round where the kernels do). Every expert is chosen (top-k = E) so
    that bf16 noise cannot flip a choice between the two routes."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import moe_lm_loss
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    cfg = ptt.models.Ernie45MoeConfig(
        vocab_size=1024, hidden_size=256, intermediate_size=512,
        moe_intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, num_experts=4,
        num_experts_per_tok=4, shared_expert_intermediate_size=256,
        dtype=torch.bfloat16)
    model = ptt.models.Ernie45MoeForCausalLM(
        cfg, device=dev, generator=ptt.make_generator(seed + 71, dev))
    ids = torch.randint(0, cfg.vocab_size, (2, 256), device=dev,
                        generator=ptt.make_generator(seed + 72, dev))
    params = dict(model.named_parameters())
    grads = {}
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd)
    for route in ("kernels", "plain"):
        if route == "plain":
            fa.flash_attention_fwd = fa.flash_attention_fwd_plain
            fa.flash_attention_bwd = fa.flash_attention_bwd_plain
        try:
            read = _reset_launches()
            loss = moe_lm_loss(*model(ids, return_aux=True), ids)
            grads[route] = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            n = read()
        finally:
            fa.flash_attention_fwd, fa.flash_attention_bwd = kernels
        on = route == "kernels"
        if (n["flash"] == 2) != on or (n["flash_bwd_dq"] == 2) != on:
            fail(f"moe-train (a) small: the {route} route launched {n}")
    errs = {k: _rel_l2(grads["kernels"][k], grads["plain"][k])
            for k in params}
    worst = max(errs, key=errs.get)
    log(f"[moe-train] (a) small ERNIE shape (2 layers, hidden 256, heads "
        f"2/1, d 128, 4 experts all chosen, bf16, [2, 256]): gradients "
        f"through the flash kernels vs through their plain twins on the "
        f"card, relative L2 per parameter: worst {errs[worst]:.2e} "
        f"({worst}), median {sorted(errs.values())[len(errs) // 2]:.2e} "
        f"(tol {TOL_GRAD_REL}) [{card}]")
    if errs[worst] > TOL_GRAD_REL:
        fail(f"moe-train: {worst}'s gradient through the kernels is "
             f"{errs[worst]:.3e} (relative L2) from the plain twins'")
    del model, grads
    gc.collect()
    torch.cuda.empty_cache()


def _moe_train_split(tr, step_ms, card):
    """torch.profiler over one more step of the MoE trainer: device ms by
    part. The flash kernels and the fused update by kernel name; the
    expert products are the kernels of the ops inside the MoE layers'
    ``moe_experts`` ranges (forward) and of the ``BmmBackward0`` nodes
    (the experts' bmm are the model's only ones); routing and dispatch
    the kernels inside ``moe_route`` (the forward's routing, bucket fill
    and combine); their backward those of the ``IndexBackward0`` nodes
    (the bucket fill's and the combine's gathers are the model's only
    tensor-indexed reads that take a gradient); other matmul kernels by
    name; the rest of the device's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    named = (("flash_fwd_", "flash_fwd"), ("flash_bwd_dq_", "flash_bwd_dq"),
             ("flash_bwd_dkv_", "flash_bwd_dkv"),
             ("fused_adam", "fused_update"))
    ranges = {"moe_experts": "expert_products",
              "moe_route": "routing_dispatch"}
    nodes = {"BmmBackward0": "expert_products",
             "IndexBackward0": "dispatch_combine_backward"}

    def gemm(name):
        return any(w in name.lower() for w in ("gemm", "gemv", "xmma",
                                                "cutlass", "nvjet"))

    def part_of(e):
        while e is not None:
            if e.name in ranges:
                return ranges[e.name]
            for w, part in nodes.items():
                if w in e.name:
                    return part
            e = e.cpu_parent
        return None

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train(max_steps=tr.global_step + 1)
        torch.cuda.synchronize()
    cats = dict.fromkeys(("expert_products", "routing_dispatch",
                          "dispatch_combine_backward", "flash_fwd",
                          "flash_bwd_dq", "flash_bwd_dkv", "fused_update",
                          "other_gemm", "rest"), 0.0)
    total = gemms = gemms_in_parts = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            ms = e.time_range.elapsed_us() / 1e3
            total += ms
            cat = next((c for w, c in named if w in e.name), None)
            if cat is not None:
                cats[cat] += ms
            elif gemm(e.name):
                gemms += ms
            continue
        if not e.kernels:
            continue
        part = part_of(e)
        if part is None:
            continue
        for kern in e.kernels:
            if not any(w in kern.name for w, _ in named):
                cats[part] += kern.duration / 1e3
                gemms_in_parts += kern.duration / 1e3 if gemm(kern.name) \
                    else 0.0
    if total <= 0 or cats["expert_products"] <= 0:
        log("[profile] torch.profiler charged no kernel to the MoE layers: "
            "the MoE train step's split is not measured")
        return None
    cats["other_gemm"] = gemms - gemms_in_parts
    cats["rest"] = total - sum(cats.values())
    log(f"[profile] moe train step device time (one more step under "
        f"torch.profiler): {total:.2f} ms, " + ", ".join(
            f"{k} {v:.2f} ms ({100 * v / total:.1f} %)"
            for k, v in cats.items())
        + f"; against the unprofiled median step's {step_ms:.1f} ms: device"
        f" busy {100 * total / step_ms:.1f} % [{card}]")
    return cats


def _moe_train(seed, dev, card):
    """(a) ERNIE-4.5-21B-A3B at full width cut to MOE_TRAIN_LAYERS (layer
    0 dense, the rest MoE), bf16, AdamW with fp32 masters through
    ``Trainer(loss_fn=moe_lm_loss)`` for MOE_TRAIN_STEPS steps on one
    repeated [2, 2048] batch. Counts set to 0 just before and read just
    after: the flash forward, dq and dk/dv once per layer and step on the
    wgmma route, the fused update once a step. The loss must stay finite
    and fall. Returns the launches."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import moe_lm_loss
    from paddle_tpu_torch.utils.profiler import llama_flops_per_token

    class StepClock(ptt.TrainerCallback):
        def __init__(self):
            self.t = []

        def on_step_end(self, step, logs):
            self.t.append(time.perf_counter())

    cfg = ptt.models.Ernie45MoeConfig(num_hidden_layers=MOE_TRAIN_LAYERS)
    L, E, k = cfg.num_hidden_layers, cfg.num_experts, cfg.num_experts_per_tok
    t0 = time.perf_counter()
    model = ptt.models.Ernie45MoeForCausalLM(
        cfg, device=dev, generator=ptt.make_generator(seed + 70, dev))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    routed = sum(p.numel() for n, p in model.named_parameters()
                 if n.split(".")[-1] in ("w_gate", "w_up", "w_down"))
    embed = model.model.embed_tokens.weight.numel()
    # active a token: all but the input table and the unchosen experts
    active = n_params - embed - routed + routed * k // E
    state_gb = n_params * STATE_BYTES_PER_PARAM / 1e9
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    log(f"[moe-train] ERNIE-4.5-21B-A3B at full width (hidden "
        f"{cfg.hidden_size}, {E} experts top-{k} of width "
        f"{cfg.moe_intermediate_size}, heads {cfg.num_attention_heads}/"
        f"{cfg.num_key_value_heads})"
        f" cut to {L} layers (layer 0 dense): {n_params / 1e9:.3f} B params"
        f" ({active / 1e9:.3f} B active a token: the routed experts' "
        f"{routed / 1e9:.3f} B counted {k}/{E}, the input table not), "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s; training "
        f"state at {STATE_BYTES_PER_PARAM} B a parameter {state_gb:.1f} GB "
        f"of the card's {total_gb:.1f} GB")
    rs = np.random.RandomState(seed + 73)
    batch = [rs.randint(0, cfg.vocab_size, MOE_TRAIN_BATCH)]
    clock = StepClock()
    opt = ptt.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01, multi_precision=True,
        grad_clip=ptt.optimizer.ClipGradByGlobalNorm(1.0))
    tr = ptt.Trainer(model, opt, ptt.TrainingArguments(
        output_dir="output/chip_smoke_moe_train",
        max_steps=MOE_TRAIN_STEPS, logging_steps=1),
        loss_fn=lambda m, b: moe_lm_loss(*m(b, return_aux=True), b),
        train_dataloader=batch, callbacks=[clock])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    read = _reset_launches()
    clock.t = [time.perf_counter()]
    tr.train(max_steps=MOE_TRAIN_STEPS - 1)
    # the last step's drops, read by hooks outside the timed steps
    seen, handles = _moe_drop_hooks(model)
    tr.train(max_steps=MOE_TRAIN_STEPS)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    launches = read()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [v for _, v in tr.logger.history["loss"]]
    step_ms = float(np.median(np.diff(clock.t)[1:-1] * 1e3))
    tokens = int(np.prod(MOE_TRAIN_BATCH))
    fpt = llama_flops_per_token(active, L, MOE_TRAIN_BATCH[1],
                                cfg.hidden_size)
    mfu = tokens / (step_ms / 1e3) * fpt / BF16_FLOP_PER_S
    dropped = sum(d for d, _ in seen) / max(sum(n for _, n in seen), 1)
    log(f"[moe-train] losses: " + ", ".join(f"{x:.4f}" for x in losses))
    log(f"[moe-train] step {step_ms:.1f} ms (median of steps 2-"
        f"{MOE_TRAIN_STEPS - 1}), {tokens / (step_ms / 1e3):.0f} tokens/s, "
        f"MFU {100 * mfu:.2f} % over the active parameters (6N + attention"
        f", {fpt / 1e9:.2f} GFLOP a token, against "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s); peak memory {peak_gb:.1f} "
        f"GB ({total_gb - peak_gb:.1f} GB free); the last step dropped "
        f"{100 * dropped:.2f} % of its "
        f"routed choices ({sum(d for d, _ in seen)} of "
        f"{sum(n for _, n in seen)}) [{card}]")
    S = MOE_TRAIN_STEPS
    want = dict(NO_LAUNCHES, flash=L * S, flash_bwd_dq=L * S,
                flash_bwd_dkv=L * S, fused_adamw=S)
    log(f"[moe-train] launches in {S} steps: {launches} (want {want})")
    if launches != want:
        fail(f"moe-train: launches {launches} != {want}")
    _check_routes("moe-train", flash=L * S, flash_bwd_dq=L * S,
                  flash_bwd_dkv=L * S)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"moe-train: the loss did not fall: {losses}")
    if total_gb - peak_gb < MIN_FREE_GB:
        fail(f"moe-train: {total_gb - peak_gb:.1f} GB left free at the peak"
             f" (want {MIN_FREE_GB})")
    _moe_train_split(tr, step_ms, card)
    del tr, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree("output/chip_smoke_moe_train", ignore_errors=True)
    return launches


def _pp_schedules(seed, dev, card):
    """(b) The pipeline code on the card: a world-one NCCL mesh naming pp
    (degree 1: the hand-offs stay on the rank), Llama-3-8B width at
    PP_LAYERS layers, tokens [M, 1, 2048]. ``pipeline_functional(1)``
    (1F1B) and ``pipeline_functional(1, vpp=2)`` (interleaved), each
    through ``pipeline_grads`` (the Trainer's pipeline step up to its
    update), against the plain accumulated step on the same weights and
    batch: the loss
    within fp32 rounding (bit for bit printed), every flat gradient
    within TOL_GRAD_REL (relative L2). Counts set to 0 just before each
    run and read just after. Returns the launches of the two pipeline
    runs."""
    import numpy as np
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import env, fleet
    from paddle_tpu_torch.models.llama import causal_lm_loss
    from paddle_tpu_torch.parallel import sharding
    from paddle_tpu_torch.parallel.pipeline import pipeline_grads

    fleet.init(strategy=fleet.DistributedStrategy(
        hybrid_configs={"pp_degree": 1}))
    mesh = env.get_mesh()
    model = _train_model(seed, dev, layers=PP_LAYERS)
    fleet.distributed_model(model)
    params = dict(model.named_parameters())
    M = PP_MICRO[0]
    rs = np.random.RandomState(seed + 74)
    tokens = torch.from_numpy(rs.randint(0, model.config.vocab_size,
                                         PP_MICRO)).to(dev)
    log(f"[pp] mesh {mesh.shape} on {mesh.device}, backend "
        f"{dist.get_backend()}, world {dist.get_world_size()}; Llama-3-8B "
        f"width, {PP_LAYERS} layers, tokens {list(PP_MICRO)}")

    def plain():
        loss, acc = 0.0, None
        for m in range(M):
            lm = causal_lm_loss(model(tokens[m]), tokens[m])
            g = torch.autograd.grad(lm, list(params.values()))
            acc = list(g) if acc is None else [a + b for a, b in
                                               zip(acc, g)]
            loss = loss + lm.detach().float()
        sharding.release(model)
        return loss / M, {k: sharding.local(a) / M for k, a in
                          zip(params, acc)}

    def piped(vpp):
        # the Trainer's pipeline step up to its update
        loss, g = pipeline_grads(model, model.pipeline_functional(
            1, vpp=vpp), tokens)
        return loss, {k: sharding.local(a) for k, a in g.items()}

    runs, launches = {}, {}
    for arm in ("plain", "vpp1", "vpp2", "plain"):
        fn = plain if arm == "plain" else (lambda v=int(arm[-1]): piped(v))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        read = _reset_launches()
        t0 = time.perf_counter()
        loss, grads = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = read()
        runs.setdefault(arm, []).append(
            (float(loss), grads, ms,
             torch.cuda.max_memory_allocated(dev) / 1e9))
        launches[arm] = n
    L = PP_LAYERS
    want = {"plain": L * M, "vpp1": L * M, "vpp2": L * M + L // 2 * M}
    ref_loss, ref = runs["plain"][0][:2]
    for arm in ("vpp1", "vpp2"):
        loss, grads, ms, peak = runs[arm][0]
        errs = {k: _rel_l2(grads[k], ref[k]) for k in ref}
        worst = max(errs, key=errs.get)
        log(f"[pp] {arm}: loss {loss:.6f} vs plain {ref_loss:.6f} "
            f"(difference {loss - ref_loss:+.3e}, bit for bit "
            f"{loss == ref_loss}); gradients' relative L2 worst "
            f"{errs[worst]:.2e} ({worst}), median "
            f"{sorted(errs.values())[len(errs) // 2]:.2e} (tol "
            f"{TOL_GRAD_REL}); launches {launches[arm]}")
        log(f"[time] pp {arm} step (forward + backward, {M} microbatches) "
            f"{ms:.1f} ms against the plain accumulated step's "
            f"{runs['plain'][0][2]:.1f} / {runs['plain'][1][2]:.1f} ms "
            f"(before / after); peak memory {peak:.1f} GB against "
            f"{runs['plain'][0][3]:.1f} GB [{card}]")
        if abs(loss - ref_loss) > 1e-6 * abs(ref_loss):
            fail(f"pp {arm}: loss {loss} != the plain step's {ref_loss}")
        if errs[worst] > TOL_GRAD_REL:
            fail(f"pp {arm}: {worst}'s gradient is {errs[worst]:.3e} "
                 f"(relative L2) from the plain step's")
        n = launches[arm]
        if (n["flash"], n["flash_bwd_dq"], n["flash_bwd_dkv"]) != (
                want[arm], L * M, L * M):
            fail(f"pp {arm}: launches {n}, want flash {want[arm]}, dq and "
                 f"dk/dv {L * M}")
    if runs["plain"][0][0] != runs["plain"][1][0]:
        fail("pp: the plain step's loss is not repeatable")
    del model, runs, ref
    env.clear_mesh()
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches["vpp1"][k] + launches["vpp2"][k]
            for k in ("flash", "flash_bwd_dq", "flash_bwd_dkv")}


def phase_pp_ep(seed, dev, card):
    """Pipeline and expert parallel training on one card (``[moe-train]``
    and ``[pp]`` lines): (a) the flash kernels at the MoE train step's
    attention shape against their plain versions, an MoE model trains
    through the Trainer (its step's device time split under the
    profiler), and its gradients at a small width hold to the plain
    route; (b) the 1F1B and interleaved schedules at pp 1, through the
    Trainer's pipeline step, against the plain step. pp > 1 and ep > 1
    need several ranks, and NCCL refuses two on one card: they are
    proved in the CPU gloo worlds (tests/test_torch_pipeline.py,
    tests/test_torch_ep.py). Returns the launches for the kernels line."""
    t0 = time.perf_counter()
    _moe_attn_check(seed, dev)
    _moe_grad_routes(seed, dev, card)
    launches = _moe_train(seed, dev, card)
    for key, n in _pp_schedules(seed, dev, card).items():
        launches[key] += n
    log(f"[pp] phase {time.perf_counter() - t0:.1f} s")
    return launches


# the fleet phase: seconds a replica process may take to print its
# readiness line (a fresh process imports torch, draws Llama-3-8B on the
# card, loads the kernels and captures its greedy and sampled tick
# graphs), and seconds the frontend waits for a peer's next line before
# reading the peer as dead (three processes time-slice the card, and a
# request's first token waits behind the other requests' prefills)
FLEET_SPAWN_TIMEOUT_S = 300
FLEET_PEER_READ_TIMEOUT_S = 120
# the prefix-sharing requests that must route warm (the ladder's warm or
# sticky verdict), of the 15 that follow the first: the frontend routes
# on probe snapshots up to one interval old, and a follower routed after
# a probe saw the first ones' load spills past ``spill_margin`` by design
FLEET_MIN_WARM = 12


async def _sse_timed(port, payload, units):
    """One SSE request: (status, final event, t_sent). Each token lands
    in ``units`` as it arrives, as (token, lp, time.perf_counter())."""
    import asyncio
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode()
    try:
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode()
                     + body)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        while (await reader.readline()) not in (b"\r\n", b"\n", b""):
            pass
        final = None
        while status == 200:
            ln = await reader.readline()
            if not ln:
                break
            ln = ln.strip()
            if not ln.startswith(b"data: "):
                continue
            ev = json.loads(ln[6:])
            if ev.get("done"):
                final = ev
                break
            units.append((ev["token"], ev.get("lp"), time.perf_counter()))
        return status, final, t0
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass


def _replica_doc(peer, path):
    """A replica gateway's JSON answer on ``path``, read by the fleet's
    own adapter (the replica's side of the counts)."""
    return peer._get_json(path)


def _ragged_of(debugz):
    k = debugz.get("kernel_launches", {}).get("ragged_paged_attention") \
        or {"launches": 0, "by_route": {}}
    return k["launches"], dict(k["by_route"])


def _taken(routes):
    return {r for r, n in routes.items() if n}


def _prefix_hits(healthz):
    return sum(int(r["engine"].get("prefix_hit_tokens", 0))
               for r in healthz["replicas"].values())


def _decode_steps(healthz):
    return sum(int(r["engine"].get("decode_steps", 0))
               for r in healthz["replicas"].values())


def phase_fleet(seed, dev, card):
    """The serving fleet on the one card: two ``replica_main`` processes,
    each Llama-3-8B at full width and depth from ``seed`` through the
    ``PagedEngine`` at the gateway phase's geometry, spawned by
    ``LocalProcessManager`` behind a ``FleetFrontend`` in this process;
    the gateway phase's 24 requests through the frontend; one replica
    SIGKILLed while at least two greedy SSE streams on it are mid-flight.
    Every stream against a direct engine on this process's own model
    from the same seed: bit for bit where nothing failed over, and where
    a stream failed over, bit for bit the direct engine's own resume of
    the committed prefix (the survivor prefills what the dead replica
    had decoded, so its logits are not the uninterrupted run's bits; how
    far the tokens agree with the uninterrupted run is printed). Each
    replica's ragged launches are read from its ``/debugz``. Returns the
    ragged launches the replicas made in the traffic."""
    import asyncio
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.serving.fleet import (FleetFrontend,
                                                LocalProcessManager)
    from paddle_tpu_torch.serving.fleet.replica_main import \
        llama3_8b_engine_kw
    t_phase = time.perf_counter()
    client = _tests_module("test_torch_gateway_gpu")
    cfg = ptt.llama3_8b()
    L = cfg.num_hidden_layers
    geo = dict(PAGED, chunk_prefill_tokens=128, enable_prefix_cache=True)
    if llama3_8b_engine_kw() != geo:
        fail(f"fleet: replica_main's llama3-8b geometry "
             f"{llama3_8b_engine_kw()} is not the gateway phase's {geo}")
    rs = np.random.RandomState(seed + 30)
    gen = ptt.make_generator(seed + 31, "cpu")
    reqs = _gateway_traffic(
        rs, lambda n: torch.randint(0, cfg.vocab_size, (n,),
                                    generator=gen).tolist())
    by_id = {r["request_id"]: r for r in reqs}
    greedy_sse = {r["request_id"] for r in reqs
                  if r["stream"] and "temperature" not in r}
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    fe = FleetFrontend([], chunk_tokens=128, name="chip-fleet",
                       peer_read_timeout_s=FLEET_PEER_READ_TIMEOUT_S)
    mgr = LocalProcessManager(fe, model="llama3-8b", chunk_tokens=128,
                              seed=seed,
                              spawn_timeout_s=FLEET_SPAWN_TIMEOUT_S,
                              probe_interval_s=0.25, stale_after_s=10.0,
                              log_dir=log_dir)
    procs = {}
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            spawns = [pool.submit(mgr.spawn) for _ in range(2)]
            try:
                peers = [f.result() for f in spawns]
            except Exception as e:
                for name in os.listdir(log_dir):
                    with open(os.path.join(log_dir, name)) as f:
                        log(f"[fleet] {name}: ...{f.read()[-3000:]}")
                fail(f"fleet: a replica did not start: {e!r}")
        cold_s = time.perf_counter() - t0
        procs = dict(mgr.procs)
        base, hit0 = {}, {}
        for p in peers:
            hz = _replica_doc(p, "/healthz")
            base[p.name] = (_ragged_of(_replica_doc(p, "/debugz"))[0],
                            _decode_steps(hz))
            hit0[p.name] = _prefix_hits(hz)
        log(f"[fleet] two replica_main processes (--model llama3-8b "
            f"--seed {seed}: PagedEngine({geo}), warmed and graphed "
            f"before ready) up in {cold_s:.1f} s, spawned together; card "
            f"memory free before {free / 2**30:.1f} of "
            f"{total / 2**30:.1f} GiB; ragged launches and decode ticks "
            f"of the warm-up {base} [{card}]")
        results, wall, kill, end_docs, hz_fe, ring = asyncio.run(
            _fleet_traffic(fe, mgr, reqs, greedy_sse, client))
        # the direct engine on this process's own model, from the seed
        model = ptt.LlamaForCausalLM(cfg, device=dev,
                                     generator=ptt.make_generator(seed,
                                                                  dev))
        direct = PagedEngine(model, **geo)
        for r in reqs:
            kw = {k: v for k, v in r.items()
                  if k not in ("prompt", "request_id", "stream")}
            direct.submit(r["request_id"], torch.as_tensor(r["prompt"]),
                          **kw)
        ref = direct.run()
        ref_lps = dict(direct.logprobs)
        committed = {}
        for e in ring:
            offs = [f for _, k, f in e.get("events", ())
                    if k == "resume_offset"]
            if e.get("failovers"):
                committed[e["request_id"]] = offs[-1]["committed"] \
                    if offs else 0
        # time to resume: the kill to the first token the survivor
        # produced (the one after the committed prefix)
        resume_ms = sorted(
            (results[rid]["times"][c] - kill["t_kill"]) * 1e3
            for rid, c in committed.items()
            if rid in greedy_sse and 0 < c < len(results[rid]["times"]))
        resumed = {}
        for rid, c in committed.items():
            r = by_id[rid]
            if c and "temperature" not in r:
                done = ref[rid][:c]
                direct.submit(f"{rid}.resume",
                              torch.as_tensor(r["prompt"] + done),
                              max_new_tokens=r["max_new_tokens"] - c,
                              resume_tokens=done,
                              resume_lps=ref_lps[rid][:c])
        if any(c and "temperature" not in by_id[rid]
               for rid, c in committed.items()):
            out = direct.run()
            for rid in committed:
                if f"{rid}.resume" in out:
                    resumed[rid] = (out[f"{rid}.resume"],
                                    direct.logprobs[f"{rid}.resume"])
        _fleet_check(reqs, results, ref, ref_lps, committed, resumed,
                     kill, greedy_sse, model, card)
        cached = {kill["peer"]: _prefix_hits(kill["healthz"]),
                  end_docs["peer"]: _prefix_hits(end_docs["healthz"])}
        log(f"[fleet] prefix_hit_tokens in the traffic by replica "
            f"{ {k: v - hit0[k] for k, v in cached.items()} } (the killed "
            f"one's up to the kill; requests admitted together cannot "
            f"adopt a prefix none of them has prefilled yet)")
        # the replicas' own counts
        survivor = end_docs["peer"]
        launched = {}
        n0, s0 = base[kill["peer"]]
        launched[kill["peer"]] = kill["ragged"] - n0
        n1, routes1 = _ragged_of(end_docs["debugz"])
        s1 = _decode_steps(end_docs["healthz"])
        b_n, b_s = base[survivor]
        launched[survivor] = n1 - b_n
        if n1 - b_n != L * (s1 - b_s) or _taken(routes1) != {"mma"} \
                or kill["ragged"] % L or not kill["ragged"] > n0 \
                or _taken(kill["routes"]) != {"mma"}:
            fail(f"fleet: replica ragged launches: survivor {n1 - b_n} in "
                 f"{s1 - b_s} ticks (want {L} x ticks, by route "
                 f"{routes1}); killed replica {kill['ragged']} by route "
                 f"{kill['routes']} (since warm-up {kill['ragged'] - n0})")
        log(f"[fleet] ragged launches read from each replica's /debugz "
            f"(hand-written ragged_mma_kernel, by route): killed "
            f"{kill['peer']} {kill['ragged'] - n0} in the traffic up to "
            f"the kill ({kill['routes']}, {kill['ragged']} since the "
            f"process began); survivor {survivor} {n1 - b_n} = {L} x "
            f"{s1 - b_s} ticks ({routes1}) [{card}]")
        ttft = np.array([v["ttft_ms"] for v in results.values()
                         if v["ttft_ms"] is not None])
        new_tokens = sum(len(v["tokens"]) for v in results.values())
        log(f"[fleet] 24 requests through the FleetFrontend (16 SSE, 8 "
            f"JSON, 4 sampled; 16 share a 512-token prefix; prompts "
            f"520-900, 64-128 new): {new_tokens} new tokens in "
            f"{wall:.2f} s, {new_tokens / wall:.1f} new tokens/s; client "
            f"TTFT (SSE) p50 {np.percentile(ttft, 50):.1f} ms p99 "
            f"{np.percentile(ttft, 99):.1f} ms; frontend failovers "
            f"{hz_fe['peer_failovers']}, retry budget exhausted "
            f"{hz_fe['retry_budget_exhausted']}; time to resume after the "
            f"SIGKILL (the kill to each mid-stream greedy stream's first "
            f"token from the survivor) {[round(x, 1) for x in resume_ms]} "
            f"ms, median {np.median(resume_ms):.1f} ms; one card "
            f"time-sliced by three processes [{card}]")
        # the survivor drains on SIGTERM and exits 0; the killed one is
        # gone
        t0 = time.perf_counter()
        mgr.stop_all(grace_s=60.0)
        for p in procs.values():
            p.wait(10)
        rcs = {n: p.returncode for n, p in procs.items()}
        log(f"[fleet] survivor drained by SIGTERM in "
            f"{time.perf_counter() - t0:.1f} s; replica exit codes {rcs}; "
            f"phase {time.perf_counter() - t_phase:.1f} s [{card}]")
        if rcs[survivor] != 0 or rcs[kill["peer"]] != -signal.SIGKILL:
            fail(f"fleet: replica exit codes {rcs} (want 0 for the "
                 f"drained survivor, -9 for the killed one)")
        return sum(launched.values())
    finally:
        # nothing outlives the phase, whatever failed
        mgr.stop_all(grace_s=10.0)
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(10)
        shutil.rmtree(log_dir, ignore_errors=True)


async def _fleet_traffic(fe, mgr, reqs, greedy_sse, client):
    """Send the requests through ``fe``; SIGKILL the first replica seen
    holding two greedy SSE streams mid-flight (each with 8 tokens at the
    client and at least 24 to go); wait for every answer; read the
    survivor's counts once it idles. Returns (results, wall s, the
    kill's record, the survivor's docs, the frontend's /healthz, its
    trace ring)."""
    import asyncio
    loop = asyncio.get_running_loop()
    await fe.start()
    live = {r["request_id"]: [] for r in reqs}
    results = {}

    async def one(r):
        rid = r["request_id"]
        if r["stream"]:
            st, fin, t0 = await _sse_timed(fe.port, r, live[rid])
            units = live[rid]
            results[rid] = dict(
                status=st, final=fin or {},
                tokens=[u[0] for u in units],
                times=[u[2] for u in units],
                ttft_ms=(units[0][2] - t0) * 1e3 if units else None)
        else:
            st, _, payload = await client.http(
                fe.port, "POST", "/v1/generate", json.dumps(r).encode())
            fin = json.loads(payload)
            results[rid] = dict(status=st, final=fin,
                                tokens=fin.get("tokens"), ttft_ms=None)

    async def watch():
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            cands = []
            for p in list(fe.peers):
                doc = await loop.run_in_executor(None, _replica_doc, p,
                                                 "/debugz")
                slots = [s for rep in doc["replicas"].values()
                         for s in (rep.get("engine") or {}).get("slots")
                         or () if s]
                mid = [s["request_id"] for s in slots
                       if s["request_id"] in greedy_sse
                       and s["remaining_budget"] >= 24
                       and len(live[s["request_id"]]) >= 8]
                if len(mid) >= 2:
                    cands.append((len(slots), p.name, p, doc, mid))
            if cands:
                _, name, p, doc, mid = min(cands, key=lambda c: c[:2])
                hz = await loop.run_in_executor(None, _replica_doc, p,
                                                "/healthz")
                n, routes = _ragged_of(doc)
                router = fe.healthz()["router"]
                t_kill = time.perf_counter()
                if mgr.kill(name) != name:
                    raise RuntimeError(f"fleet: could not kill {name}")
                return dict(peer=name, ragged=n, routes=routes, mid=mid,
                            t_kill=t_kill, healthz=hz, router=router)
            await asyncio.sleep(0.05)
        raise RuntimeError("fleet: no replica held two greedy streams "
                           "mid-flight")

    t0 = time.perf_counter()
    tasks = [asyncio.ensure_future(one(r)) for r in reqs]
    kill = await watch()
    await asyncio.gather(*tasks)
    wall = time.perf_counter() - t0
    ring = fe.ring.snapshot()
    survivor = next(p for p in fe.peers if p.name != kill["peer"])
    deadline = time.monotonic() + 30
    while True:
        hz = await loop.run_in_executor(None, _replica_doc, survivor,
                                        "/healthz")
        idle = all(not r["engine"]["active_slots"]
                   and not r["engine"]["queued"]
                   for r in hz["replicas"].values())
        if idle or time.monotonic() > deadline:
            break
        await asyncio.sleep(0.1)
    dz = await loop.run_in_executor(None, _replica_doc, survivor, "/debugz")
    hz = await loop.run_in_executor(None, _replica_doc, survivor,
                                    "/healthz")
    hz_fe = fe.healthz()
    await fe.drain()
    return (results, wall, kill,
            dict(peer=survivor.name, debugz=dz, healthz=hz), hz_fe, ring)


def _fleet_check(reqs, results, ref, ref_lps, committed, resumed, kill,
                 greedy_sse, model, card):
    """Every answer complete (no token missing or repeated: the streamed
    tokens are the final event's, as many as asked); the streams that
    never failed over, and the JSON ones that restarted from nothing,
    bit for bit the direct engine's; each greedy stream that failed over
    mid-flight bit for bit the direct engine's resume of its committed
    prefix; at least two such streams; the prefix-sharing requests
    routed warm; the shared prefix hit a replica's cache."""
    by_id = {r["request_id"]: r for r in reqs}
    bad = []
    moved = []
    for r in reqs:
        rid = r["request_id"]
        res = results[rid]
        fin = res["final"]
        toks = res["tokens"]
        if res["status"] != 200 or fin.get("finish_reason") != "stop" \
                or fin.get("tokens") != toks \
                or len(toks) != r["max_new_tokens"]:
            fail(f"fleet {rid}: status {res['status']}, finish "
                 f"{fin.get('finish_reason')}, {len(toks or ())} tokens "
                 f"streamed against {len(fin.get('tokens') or ())} in the "
                 f"final event, {r['max_new_tokens']} asked")
        if "temperature" in r and rid in committed:
            continue        # a sampled failover re-derives its seed
        c = committed.get(rid, 0)
        if c == 0:
            if toks != ref[rid] or fin["logprobs"] != ref_lps[rid]:
                bad.append(rid)
            continue
        want, want_lps = resumed[rid]
        same = toks == want and fin["logprobs"] == want_lps
        if not same:
            bad.append(rid)
        if rid in greedy_sse and c < r["max_new_tokens"]:
            k = next((i for i, (a, b) in enumerate(zip(toks, ref[rid]))
                      if a != b), None)
            margin = None if k is None else _divergence(
                model, r["prompt"], toks, ref[rid])[1]
            moved.append((rid, c, k, margin))
    if bad:
        for rid in bad:
            if "temperature" not in by_id[rid] and rid not in committed:
                i, margin, _, _ = _divergence(
                    model, by_id[rid]["prompt"], results[rid]["tokens"],
                    ref[rid])
                log(f"[fleet] stream {rid} first differs from the direct "
                    f"engine's at token {i}: top-2 margin there "
                    f"{margin:.4f} [{card}]")
        fail(f"fleet: streams differ from the direct engine's: {bad}")
    hits = kill["router"]["prefix_route_hits"]
    log(f"[fleet] killed {kill['peer']} with greedy streams {kill['mid']} "
        f"mid-flight; failed over mid-stream and finished on the survivor "
        f"bit for bit the direct engine's resume of their committed "
        f"prefix: " + ", ".join(
            f"{rid} at token {c} ("
            + ("whole stream equal to the uninterrupted run"
               if k is None else
               f"first token unlike the uninterrupted run's at {k}, top-2 "
               f"margin there {m:.4f}") + ")"
            for rid, c, k, m in moved)
        + f"; the other {len(reqs) - len(moved)} streams bit for bit the "
        f"direct engine's; prefix routes at the kill: {hits} warm or "
        f"sticky, {kill['router']['prefix_route_misses']} cold [{card}]")
    if len(moved) < 2:
        fail(f"fleet: {len(moved)} greedy streams failed over mid-flight "
             f"(want at least 2)")
    if hits < FLEET_MIN_WARM:
        fail(f"fleet: {hits} prefix-sharing requests routed warm (want "
             f"at least {FLEET_MIN_WARM} of 15)")

# phase 15: tensor-parallel serving. The per-rank head counts (query
# heads, kv heads) tp serving launches the attention kernels at:
# Llama-3-70B (64 q over 8 kv) at tp 2, 4 and 8, Llama-3-8B (32 over 8)
# at tp 8
TP_HEADS = {"70B tp 2": (32, 4), "70B tp 4": (16, 2), "70B tp 8": (8, 1),
            "8B tp 8": (4, 1)}
TP_FLASH = (4, 512)                      # b, s of generate()'s prefill
TP_DECODE = (4, 640)                     # b, T of its static cache
# Llama-3-70B's per-rank projections at tp 4: (label, din of the rank's
# codes, dout of the rank's codes, scale blocks of the whole table, the
# rank whose offset is read); row layers keep the whole scales table and
# read their rank's blocks (the last rank's, the largest offset)
TP_QUANT = (("q col", 8192, 2048, 64, 0),
            ("k/v col", 8192, 256, 64, 0),
            ("gate/up col", 8192, 7168, 64, 0),
            ("o row", 2048, 8192, 64, 3),
            ("down row", 7168, 8192, 224, 3),
            ("qkv fused col", 8192, 2560, 64, 0),
            ("gate_up fused col", 8192, 14336, 64, 0))
TP_NEW = 64          # generate()'s new tokens in the tp phase (the slice: 128)
# the tp phase's Llama-3-8B cut to 8 of its 32 layers (b, c) for the
# script's time limit: its checks hold the sharded model to the plain one
# bit for bit, at any depth
TP_LAYERS = 8


def _tp_attention(gen, dev, card, heads=None, tag="[tp] (a)"):
    """(a) The flash forward, decode and ragged kernels (T = 1 and 5) at
    every per-rank head count of ``heads`` (``TP_HEADS``; ``tag`` heads
    the lines), bf16, against their plain
    versions (``TOL_BF16``), every launch on its tensor-core route by
    count; their device times beside the plain versions, SDPA (heads
    pre-expanded, K/V pre-gathered for the paged calls) and the bound."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_fwd_plain)
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_plain)
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        query_windows, ragged_paged_attention, ragged_paged_attention_plain)
    fb, fs = TP_FLASH
    db, dT = TP_DECODE
    d, el, R = 128, 2, 16
    ci = torch.tensor(dT - 1, dtype=torch.int32, device=dev)
    rows = []
    for label, (h, kvh) in (heads or TP_HEADS).items():
        fns = {"flash": flash_attention_fwd, "decode": decode_attention_fwd,
               "ragged": ragged_paged_attention}
        before = {k: dict(f.launches_by_route) for k, f in fns.items()}
        # checks against the plain versions
        q, k, v = flash_inputs(gen, dev, fb, fs, h, kvh, d)
        out, _ = flash_attention_fwd(q, k, v, causal=True)
        errs = {"flash": max_err(out, flash_attention_fwd_plain(
            q, k, v, causal=True)[0])}
        qd, ck, cv = (torch.randn(*s, generator=gen, device=dev)
                      .to(torch.bfloat16)
                      for s in ((db, h, d), (db, dT, kvh, d),
                                (db, dT, kvh, d)))
        errs["decode"] = max_err(decode_attention_fwd(qd, ck, cv, ci),
                                 decode_attention_fwd_plain(qd, ck, cv, ci))
        want_ragged = 0
        for T in (1, 5):
            lens = ragged_lens(gen, dev, T)
            case = paged_case(gen, dev, lens, T=T, h=h, kvh=kvh)
            errs[f"ragged T{T}"] = max_err(
                ragged_paged_attention(*case),
                ragged_paged_attention_plain(*case))
            want_ragged += len(query_windows(T, h // kvh))
        torch.cuda.synchronize()
        got = {k: {r: n - before[k][r] for r, n in
                   f.launches_by_route.items()} for k, f in fns.items()}
        want = {"flash": {"wgmma": 1, "simt": 0},
                "decode": {"mma": 1, "simt": 0},
                "ragged": {"mma": want_ragged, "simt": 0}}
        log(f"{tag} {label}: {h} query heads over {kvh} kv heads a rank, "
            f"bf16, max_abs_err against the plain versions "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (tol {TOL_BF16}); launches by route {got}")
        if got != want:
            fail(f"{tag} {label}: launches by route {got} != {want}")
        if not all(e <= TOL_BF16 for e in errs.values()):
            fail(f"{tag} {label}: a kernel disagrees with its plain "
                 f"version")
        # times: flash at the prefill shape
        call_bytes = el * (2 * fb * fs * h * d + 2 * fb * fs * kvh * d) \
            + 4 * fb * h * fs
        n = copies_for(call_bytes)
        sets = [flash_inputs(gen, dev, fb, fs, h, kvh, d) for _ in range(n)]
        lib = [tuple(t.transpose(1, 2).repeat_interleave(h // t.shape[2], 1)
                     .contiguous() for t in qkv) for qkv in sets]
        t = {"flash": dict(
            ms=graph_ms(lambda i: flash_attention_fwd(*sets[i % n],
                                                      causal=True),
                        calls=20),
            plain_ms=cuda_ms(lambda i: flash_attention_fwd_plain(
                *sets[i % n], causal=True), iters=5),
            library_ms=graph_ms(lambda i: TF.scaled_dot_product_attention(
                *lib[i % n], is_causal=True), calls=20),
            bound=bound(call_bytes, 4 * d * fb * h * fs * (fs + 1) // 2),
            shape=f"q {[fb, fs, h, d]} kv {[fb, fs, kvh, d]} causal")}
        del sets, lib
        # decode at the cache's last position
        call_bytes = el * (2 * db * h * d + 2 * db * dT * kvh * d)
        n = copies_for(call_bytes)
        sets = [tuple(torch.randn(*s, generator=gen, device=dev)
                      .to(torch.bfloat16)
                      for s in ((db, h, d), (db, dT, kvh, d),
                                (db, dT, kvh, d))) for _ in range(n)]
        lib = [(q[:, :, None], ck.transpose(1, 2).repeat_interleave(
            h // kvh, 1).contiguous(), cv.transpose(1, 2).repeat_interleave(
            h // kvh, 1).contiguous()) for q, ck, cv in sets]
        t["decode"] = dict(
            ms=graph_ms(lambda i: decode_attention_fwd(*sets[i % n], ci),
                        calls=60),
            plain_ms=graph_ms(lambda i: decode_attention_fwd_plain(
                *sets[i % n], ci), calls=10),
            library_ms=graph_ms(lambda i: TF.scaled_dot_product_attention(
                *lib[i % n]), calls=60),
            bound=bound(call_bytes, 4 * d * db * h * dT),
            shape=f"q {[db, h, d]} cache {[db, dT, kvh, d]} at {dT - 1}")
        del sets, lib
        # ragged over the engine's pools at T = 1 and the verify's T = 5
        for T in (1, 5):
            lens = torch.randint(64, 1024 - T, (R,), generator=gen,
                                 device=dev)
            kv_pos = int((lens + T).sum())
            att = int((T * (lens + 1) + T * (T - 1) // 2).sum())
            call_bytes = el * (2 * kv_pos * kvh * d + 2 * R * T * h * d)
            n = copies_for(call_bytes)
            sets = [paged_case(gen, dev, lens, T=T, h=h, kvh=kvh)
                    for _ in range(n)]
            lib, mask = sdpa_inputs(sets, lens, T)
            t[f"ragged T{T}"] = dict(
                ms=graph_ms(lambda i: ragged_paged_attention(*sets[i % n]),
                            calls=40),
                plain_ms=cuda_ms(lambda i: ragged_paged_attention_plain(
                    *sets[i % n]), iters=10),
                library_ms=graph_ms(lambda i: TF.scaled_dot_product_attention(
                    *lib[i % n], attn_mask=mask), calls=40),
                bound=bound(call_bytes, 4 * d * h * att),
                shape=f"q {[R, T, h, d]}, pools [1025, 16, {kvh}, {d}], "
                      f"{len(query_windows(T, h // kvh))} launch(es) a call")
            del sets, lib
        for key, r in t.items():
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            log(f"{tag} time {key}, {label}, {r['shape']}: kernel "
                f"{r['ms']:.4f} ms (device time, CUDA graph), plain "
                f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
            rows.append((label, key, r))
    return rows


def _tp_quant(gen, dev, card, table=TP_QUANT, bits_set=(8, 4),
              tag="[tp] (a)", rows_m=(4, 16)):
    """(a) The quant kernel at Llama-3-70B's per-rank projections at tp 4
    (``table``: ``TP_QUANT``), int8 and int4 (``bits_set``), m = 4 and 16
    (``rows_m``; ``tag`` heads the lines): the row layers through
    the wrapper's ``block_offset`` into the whole scales table. Each
    against its plain version over the rank's scale blocks (``TOL_QUANT_*``),
    on the mma route by count; its device time beside the plain version,
    a bf16 matmul on the dequantized weight and the bound."""
    from paddle_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul, quant_matmul_plain)
    from paddle_tpu_torch.quant import dequantize_weight
    rows = []
    for bits in bits_set:
        for label, din, dout, blocks, rank in table:
            nb = din // 128
            off = rank * nb
            code_bytes = din * dout * bits // 8
            n = copies_for(code_bytes)
            sets = []
            for _ in range(n):
                codes, _ = _quantized(gen, dev, din, dout, bits)
                scales = (torch.rand(blocks, dout, generator=gen, device=dev)
                          * 1e-3 + 1e-4).to(torch.bfloat16)
                sets.append((codes, scales))
            ws = [dequantize_weight(c, s[off:off + nb], bits,
                                    dtype=torch.bfloat16) for c, s in sets]
            for m in rows_m:
                x = torch.randn(m, din, generator=gen,
                                device=dev).to(torch.bfloat16)
                mma0 = quant_matmul.launches_by_route["mma"]
                got = quant_matmul(x, *sets[0], bits, block_offset=off)
                ref = quant_matmul_plain(x, sets[0][0],
                                         sets[0][1][off:off + nb], bits)
                torch.cuda.synchronize()
                bad = ((got.float() - ref.float()).abs()
                       > TOL_QUANT_REL * ref.float().abs()
                       + TOL_QUANT_ABS * ref.float().abs().max())
                err = max_err(got, ref)
                if quant_matmul.launches_by_route["mma"] != mma0 + 1:
                    fail(f"{tag} quant {label}: not one mma launch")
                if bool(bad.any()):
                    fail(f"{tag} quant int{bits} {label} m={m}: "
                         f"{int(bad.sum())} elements off the plain version "
                         f"(max_abs_err {err:.3e})")
                nbytes = (code_bytes + 2 * nb * dout + 2 * m * (din + dout))
                b_ms, b_by = bound(nbytes, 2 * m * din * dout)
                r = dict(
                    ms=graph_ms(lambda i: quant_matmul(
                        x, *sets[i % n], bits, block_offset=off), calls=60),
                    plain_ms=graph_ms(lambda i: quant_matmul_plain(
                        x, sets[i % n][0], sets[i % n][1][off:off + nb],
                        bits), calls=6),
                    library_ms=graph_ms(lambda i: torch.matmul(x, ws[i % n]),
                                        calls=60),
                    bound_ms=b_ms, bound_by=b_by, err=err)
                log(f"{tag} quant int{bits} {label} {din}->{dout} m={m}"
                    f" (scale blocks {off}..{off + nb} of {blocks}): "
                    f"max_abs_err {err:.3e}; kernel {r['ms']:.4f} ms (device "
                    f"time, CUDA graph), plain {r['plain_ms']:.4f} ms, bf16 "
                    f"matmul on the dequantized weight "
                    f"{r['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
                    f"({b_by}) [{card}]")
                rows.append((f"int{bits} {label} m={m}", r))
            del sets, ws
    return rows


def _tp_generate(pred, ids, new, label):
    """One warmed greedy ``generate`` timed on the host (closed by a
    synchronize), the counts set to 0 just before it and read just after,
    and its decode step's graph kernel nodes. Returns (tokens, decode ms a
    step, kernel nodes, launches, quant nodes)."""
    import paddle_tpu_torch as ptt
    b, prompt = ids.shape
    greedy = ptt.GenerationConfig(max_new_tokens=new)
    one = ptt.GenerationConfig(max_new_tokens=1)
    pred.generate(ids, config=greedy)
    pred.generate(ids, config=one)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.generate(ids, config=one)
    torch.cuda.synchronize()
    prefill = time.perf_counter() - t0
    read = _reset_launches()
    t0 = time.perf_counter()
    out = pred.generate(ids, config=greedy)
    torch.cuda.synchronize()
    step_ms = ((time.perf_counter() - t0) - prefill) * 1e3 / (new - 1)
    launches = read()
    prog = _step_program(pred.model, lambda k: k[:4] == (
        "generate", b, prompt + new, False), label)
    names, _ = graph_nodes(prog.step.graph.graph)
    return (out, step_ms, len(names), launches,
            sum("qmm_mma" in n for n in names))


class _ReplayCount:
    """Counts ``torch.cuda.CUDAGraph.replay`` calls while it is on."""

    def __enter__(self):
        self.n, self._orig = 0, torch.cuda.CUDAGraph.replay
        count = self

        def replay(graph, *a, **kw):
            count.n += 1
            return count._orig(graph, *a, **kw)
        torch.cuda.CUDAGraph.replay = replay
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self._orig


def _tp_engine(model, subs, warm, **kw):
    """The tp phase's engine (chunked prefill 128, the prefix cache) over
    ``subs`` after the ``warm`` requests (a
    greedy and a sampled one: the tick programs' captures); returns
    (results, logprobs, engine, ticks, replays, launches)."""
    from paddle_tpu_torch.generation.paged import PagedEngine
    eng = PagedEngine(model, chunk_prefill_tokens=128,
                      enable_prefix_cache=True, **PAGED,
                      **kw)
    for w in warm:      # each tick program alone: greedy, then sampled
        _serve(eng, [w], late_after=0)
    steps0 = eng.stats["decode_steps"]
    read = _reset_launches()
    with _ReplayCount() as rc:
        out, _, _, _ = _serve(eng, subs, late_after=4)
    launches = read()
    ticks = eng.stats["decode_steps"] - steps0
    return out, dict(eng.logprobs), eng, ticks, rc.n, launches


def _tp_serving(seed, dev, card):
    """(b) Llama-3-8B at full width, ``TP_LAYERS`` deep, on a world-one NCCL mesh
    ({"tp": 1}): sharded, bound once, through ``Predictor.generate`` and
    the ``PagedEngine``, bit for bit the same weights unsharded in this
    process (a second model from the same seed), steps and ticks timed
    in turns; (c) ``fuse_projections`` on it in bf16 and int8. Returns
    the sharded paths' launches."""
    import numpy as np
    import torch.distributed as dist

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.nn.fuse import fuse_projections
    from paddle_tpu_torch.parallel.sharding import (bind_static, local,
                                                    shard_layer,
                                                    sharded_build)
    cfg = ptt.llama3_8b(num_hidden_layers=TP_LAYERS)
    L = cfg.num_hidden_layers
    new = TP_NEW

    def build():
        return ptt.LlamaForCausalLM(cfg, device=dev,
                                    generator=ptt.make_generator(seed, dev))
    plain = build()
    mesh = env.init_parallel_env({"tp": 1})
    # each decoder layer cut to this rank's shards as it is drawn
    with sharded_build(fsdp_min_size=1 << 30):
        sharded = build()
    shard_layer(sharded, fsdp_min_size=1 << 30)
    bound_t = bind_static(sharded)
    same = all(torch.equal(a, local(b)) for a, b in zip(
        plain.parameters(), sharded.parameters()))
    aliased = all(bound_t[n].data_ptr() == local(p).data_ptr()
                  for n, p in sharded.named_parameters())
    log(f"[tp] (b) Llama-3-8B at full width, {L} of its 32 layers, twice "
        f"from seed "
        f"{seed}: one plain, one built sharded (sharded_build) on mesh "
        f"{mesh.shape} over "
        f"{dist.get_backend()} (world {dist.get_world_size()}) and bound "
        f"once (bind_static): weights equal {same}, every compute tensor "
        f"the local shard itself {aliased}; at tp 1 every tp collective "
        f"is the identity, so the captured graphs hold none")
    if not (same and aliased):
        fail("tp (b): the sharded model's weights are not the plain ones")
    del bound_t
    pa = ptt.Predictor(plain, device=dev)
    pb = ptt.Predictor(sharded, device=dev)
    ids = torch.randint(0, cfg.vocab_size, (4, 512), device=dev,
                        generator=ptt.make_generator(seed + 1, dev))
    want = dict(NO_LAUNCHES, flash=L, decode=L * (new - 1))
    ra = _generate_run(ptt, pa, ids, new, want, "tp plain", dev, card)
    rb = _generate_run(ptt, pb, ids, new, want, "tp sharded", dev, card)
    launches = dict(rb["launches"])
    if not torch.equal(ra["out"], rb["out"]):
        fail("tp (b): the sharded model's greedy tokens differ from the "
             "plain model's")
    turns = {"plain": [], "sharded": []}
    for arm in ("plain", "sharded", "sharded", "plain"):
        turns[arm].append(_tp_generate(pa if arm == "plain" else pb, ids,
                                       new, arm)[1])
    log(f"[tp] (b) generate 4 x 512 + {new}, greedy: tokens bit for bit the "
        f"plain model's; decode step in turns plain "
        + "/".join(f"{x:.3f}" for x in turns["plain"]) + " ms, sharded "
        + "/".join(f"{x:.3f}" for x in turns["sharded"]) + f" ms [{card}]")

    # the engine: 8 requests on a 384-token shared prefix, one sampled
    gen = ptt.make_generator(seed + 30, "cpu")

    def toks(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen)
    warm = [("w0", toks(200), dict(max_new_tokens=4)),
            ("w1", toks(200), dict(max_new_tokens=4, temperature=0.8,
                                   seed=3))]
    prefix = toks(384)
    subs = [(f"t{i}", torch.cat([prefix, toks(64)]),
             dict(max_new_tokens=32, **(dict(temperature=0.8, top_p=0.95,
                                             seed=77) if i == 5 else {})))
            for i in range(8)]
    ticks_ms = {}
    for spec in (0, 4):
        kw = dict(SPEC) if spec else {}
        tag = "spec" if spec else "paged"
        oa, la, ea, ta, _, _ = _tp_engine(plain, subs, warm, **kw)
        ob, lb, eb, tb, rep, lb_launches = _tp_engine(sharded, subs, warm,
                                                      **kw)
        _same_streams(f"tp (b) {tag}", ob, lb, oa, la)
        hits = eb.stats["prefix_hit_tokens"]
        # the host cost of the tp > 1 schedule check's digest (its gloo
        # all-gather needs two ranks, and is not timed here)
        t0 = time.perf_counter()
        for _ in range(200):
            eb.schedule_digest()
        digest_us = (time.perf_counter() - t0) / 200 * 1e6
        ragged_want = lb_launches["ragged"]
        log(f"[tp] (b) PagedEngine{' spec_tokens=4' if spec else ''} "
            f"(chunk 128, prefix cache, 1 sampled of 8) on the sharded "
            f"model: streams and logprobs bit for bit the plain model's; "
            f"{tb} ticks, {rep} graph replays, prefix_hit_tokens {hits}, "
            f"launches {lb_launches}; one schedule digest "
            f"{digest_us:.1f} us on the host [{card}]")
        if rep != tb or hits <= 0:
            fail(f"tp (b) {tag}: {rep} graph replays for {tb} ticks, "
                 f"prefix hits {hits}")
        if ragged_want != L * tb or lb_launches["flash"] \
                or lb_launches["decode"]:
            fail(f"tp (b) {tag}: launches {lb_launches}")
        _check_routes(f"tp (b) {tag}", ragged=ragged_want)
        if not spec:
            launches["ragged"] = ragged_want
        ea_ms, eb_ms = [], []
        for eng, acc in ((ea, ea_ms), (eb, eb_ms), (eb, eb_ms), (ea, ea_ms)):
            _fill(eng, toks, 32)
            for _ in range(3):          # the 256-token prompts' 2nd chunk
                eng.step()
            acc.append(_timed_ticks(eng, 16))
            eng.run()
        ticks_ms[tag] = (ea_ms, eb_ms)
        log(f"[tp] (b) steady {tag} tick, 16 rows, in turns: plain "
            + "/".join(f"{x:.3f}" for x in ea_ms) + " ms, sharded "
            + "/".join(f"{x:.3f}" for x in eb_ms) + f" ms [{card}]")
        del ea, eb
    gc.collect()

    # (c) fused projections, bf16: the sharded model fused in place
    unfused = _tp_generate(pb, ids, new, "tp unfused")
    logits = pa.run(ids)[:, -1].float()
    fuse_projections(sharded)
    fused = _tp_generate(pb, ids, new, "tp fused")
    gaps = [_teacher_gap(plain, ids[r].tolist(), fused[0][r, 512:].tolist())
            for r in range(ids.shape[0])]
    flogits = pb.run(ids)[:, -1].float()
    ldiff = float((flogits - logits).abs().max())
    turns = {"unfused": [], "fused": []}
    for arm in ("unfused", "fused", "fused", "unfused"):
        turns[arm].append(_tp_generate(pa if arm == "unfused" else pb, ids,
                                       new, arm)[1])
    log(f"[tp] (c) fuse_projections, bf16: decode step graph "
        f"{fused[2]} kernel nodes fused against {unfused[2]} unfused; step "
        f"in turns unfused " + "/".join(f"{x:.3f}" for x in turns["unfused"])
        + " ms, fused " + "/".join(f"{x:.3f}" for x in turns["fused"])
        + f" ms; the fused greedy streams re-scored by the unfused model: "
        f"largest gap {max(gaps):.4f} (tol {TOL_TEACHER}); last-position "
        f"logits max |diff| {ldiff:.4f} of max |logit| "
        f"{float(logits.abs().max()):.3f}; "
        f"{int((fused[0] != unfused[0]).sum())} of {4 * (512 + new)} "
        f"tokens differ [{card}]")
    if max(gaps) > TOL_TEACHER:
        fail("tp (c): a fused bf16 greedy token is not within the teacher "
             "tolerance of the unfused model's maximum")
    del pb, sharded, fused, unfused
    gc.collect()
    torch.cuda.empty_cache()

    # (c) int8: the plain model sharded, quantized by Predictor, then fused
    shard_layer(plain, fsdp_min_size=1 << 30)
    pq = ptt.Predictor(plain, ptt.Config().enable_weight_only_quant(8),
                       device=dev)
    q_unfused = _tp_generate(pq, ids, new, "tp int8 unfused")
    q_launch = q_unfused[3]["quant"]
    if q_launch != q_unfused[4] * (new - 1) or \
            q_unfused[4] != QUANT_PER_LAYER * L:
        fail(f"tp (c) int8: {q_launch} quant launches, {q_unfused[4]} "
             f"quant nodes in the step graph")
    _check_routes("tp (c) int8", quant=q_launch, decode=L * (new - 1))
    qlogits = pq.run(ids)[:, -1].float()
    fuse_projections(pq.model)
    q_fused = _tp_generate(pq, ids, new, "tp int8 fused")
    gaps = [_teacher_gap(pq.model, ids[r].tolist(),
                         q_unfused[0][r, 512:].tolist())
            for r in range(ids.shape[0])]
    qdiff = float((pq.run(ids)[:, -1].float() - qlogits).abs().max())
    launches["quant"] = q_launch
    log(f"[tp] (c) int8 on the sharded model (each rank's codes of its "
        f"shards), then fused: decode step graph {q_fused[2]} kernel "
        f"nodes ({q_fused[4]} quant) fused against {q_unfused[2]} "
        f"({q_unfused[4]} quant); step {q_fused[1]:.3f} ms fused against "
        f"{q_unfused[1]:.3f} unfused; quant launches in one unfused "
        f"generate {q_launch}, fused {q_fused[3]['quant']}; the unfused int8 streams re-scored by the fused "
        f"model: largest gap {max(gaps):.4f} (tol {TOL_TEACHER}); "
        f"last-position logits max |diff| {qdiff:.4f} [{card}]")
    if max(gaps) > TOL_TEACHER:
        fail("tp (c): an int8 greedy token is not within the teacher "
             "tolerance of the fused model's maximum")
    del pq, pa, plain
    gc.collect()
    torch.cuda.empty_cache()
    env.clear_mesh()
    dist.destroy_process_group()
    return launches


def phase_tp(seed, gen, dev, card):
    """Tensor-parallel serving on one card (``[tp]`` lines): (a) the
    kernels at the per-rank shapes tp serving launches, (b) the sharded
    serving path at a world of one, (c) fused projections. Returns the
    main path's launches."""
    _tp_attention(gen, dev, card)
    _tp_quant(gen, dev, card)
    return _tp_serving(seed, dev, card)


# phase 16: tp serving behind the fleet. 8 greedy requests share a
# 384-token prefix (tails of 16-128 tokens), one sampled; 64 new each
TP_SERVE_PREFIX = 384
TP_SERVE_NEW = 64
# the replica's spill arena, and the stream the SIGTERM drain migrates
# (a 256-token prompt: two 128-token chunks, the span /kvz serves)
TP_SERVE_SPILL_MB = 2048
TP_SERVE_KVZ_PROMPT = 256
# the replica's depth: 8 of Llama-3-8B's 32 layers at its full widths
# (``replica_main --layers``), to keep the script inside its time limit
TP_SERVE_LAYERS = 8
TP_SERVE_KVZ_NEW = 512


def _tp_serve_requests(seed, vocab):
    import numpy as np
    rs = np.random.RandomState(seed + 60)
    gen = torch.Generator().manual_seed(seed + 61)

    def ids(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()
    prefix = ids(TP_SERVE_PREFIX)
    reqs = [dict(request_id=f"t{i}",
                 prompt=prefix + ids(int(rs.randint(16, 129))),
                 max_new_tokens=TP_SERVE_NEW) for i in range(8)]
    reqs.append(dict(request_id="ts", prompt=ids(300),
                     max_new_tokens=TP_SERVE_NEW, temperature=0.8,
                     top_p=0.95, seed=seed + 62))
    return reqs


def _flash_of(debugz):
    k = debugz.get("kernel_launches", {}).get("flash_attention_fwd") \
        or {"launches": 0, "by_route": {}}
    return k["launches"], dict(k["by_route"])


async def _tp_serve_traffic(fe, reqs):
    """Every request through ``fe`` at once, SSE: {rid: (status, final
    event, tokens, TTFT ms)} and the wall seconds."""
    import asyncio
    await fe.start()
    out = {}

    async def one(r):
        units = []
        st, fin, t0 = await _sse_timed(fe.port, r, units)
        out[r["request_id"]] = (st, fin or {}, [u[0] for u in units],
                                (units[0][2] - t0) * 1e3 if units else None)
    t0 = time.perf_counter()
    await asyncio.gather(*[one(r) for r in reqs])
    wall = time.perf_counter() - t0
    await fe.drain()
    return out, wall


async def _http_get(port, path):
    """One HTTP/1.1 GET on this machine: (status, body bytes)."""
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        n = 0
        while True:
            ln = await reader.readline()
            if ln in (b"\r\n", b"\n", b""):
                break
            k, _, v = ln.decode().partition(":")
            if k.strip().lower() == "content-length":
                n = int(v.strip())
        return status, (await reader.readexactly(n) if n else b"")
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass


async def _tp_serve_kvz(port, proc, prompt):
    """A greedy stream sent to the replica itself; after its first
    tokens, SIGTERM: the drain migrates it (its span banked in the
    replica's arena, its final event naming the digest as
    ``resume_kv``), and ``/kvz`` serves that span while the drain's grace
    holds the port. Returns (final event, tokens seen, /kvz status, the
    record)."""
    import asyncio
    units = []
    task = asyncio.ensure_future(_sse_timed(port, dict(
        request_id="kvz", prompt=prompt, max_new_tokens=TP_SERVE_KVZ_NEW,
        temperature=0.0), units))
    t0 = time.monotonic()
    while len(units) < 4 and not task.done() and \
            time.monotonic() - t0 < FLEET_PEER_READ_TIMEOUT_S:
        await asyncio.sleep(0.002)
    proc.send_signal(signal.SIGTERM)
    _, fin, _ = await task
    digest = (fin or {}).get("resume_kv") or ""
    status, blob = (await _http_get(port, f"/kvz?digest={digest}")
                    if digest else (None, b""))
    return fin or {}, len(units), status, blob


def _tp_serve_kvz_check(kvz, direct, prompt, card):
    """The /kvz record of the migrated stream's span against the direct
    plain engine's arena: the same prompt served to the same span
    (chunked prefill), its parked prefix banked, the payload taken for
    the record's digest; the decoded K/V bit for bit equal. Returns the
    direct engine's ragged launches (none: the stream is one token)."""
    from paddle_tpu_torch.serving import KVSpillArena, kvxfer
    fin, seen, status, blob = kvz
    digest = fin.get("resume_kv") or ""
    geo = direct._spill_geometry()
    try:
        got_digest, tokens, payload = kvxfer.decode_span(blob, geo)
    except kvxfer.XferError as e:
        fail(f"tp-serve (a): the replica's /kvz record of {digest[:12]} "
             f"(status {status}, {len(blob)} B; stream finish "
             f"{fin.get('finish_reason')}) does not decode: {e}")
    arena = KVSpillArena(4 << 30, name="chip-tp-serve-direct")
    direct.attach_spill(arena)
    direct.submit("kvz", torch.as_tensor(prompt), max_new_tokens=1)
    direct.run()
    direct.spill_parked()
    want = arena.take(bytes.fromhex(digest), geo)
    # the records' leading blocks in common (each record the whole span
    # its digest belongs to: the migrated stream's reaches its computed
    # tokens, the direct engine's its parked prefix)
    same, blocks = False, 0
    if want is not None:
        a = kvxfer._heads_view(payload, geo)
        b = kvxfer._heads_view(want[0], geo)
        blocks = min(a.shape[1], b.shape[1])
        same = blocks > 0 and bool((a[:, :blocks] == b[:, :blocks]).all())
    log(f"[tp-serve] (a) a live stream ({len(prompt)}-token prompt) "
        f"migrated by the SIGTERM drain after {seen} tokens (finish "
        f"{fin.get('finish_reason')}, {len(fin.get('tokens', []))} "
        f"committed): GET /kvz?digest={digest[:12]}.. -> {status}, a "
        f"{len(blob)} B kvxfer record of {tokens} tokens, geometry {geo}; "
        f"its K/V bit for bit the direct plain engine's arena record of "
        f"the same span over their {blocks} blocks in common "
        f"({blocks * geo[1]} tokens): {same} [{card}]")
    if got_digest != digest or not same:
        fail("tp-serve (a): the replica's /kvz record is not the direct "
             "engine's span")
    return 0


def _tp_serve_fleet(seed, dev, card):
    """(a) One tp replica of one rank behind the fleet: spawned through
    the launcher, its streams bit for bit a direct plain engine's, its
    launches read from its /debugz, drained by SIGTERM. Returns the
    traffic's ragged launches."""
    import asyncio

    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.serving.fleet import (FleetFrontend,
                                                LocalProcessManager)
    from paddle_tpu_torch.serving.fleet.replica_main import \
        llama3_8b_engine_kw
    cfg = ptt.llama3_8b(num_hidden_layers=TP_SERVE_LAYERS)
    L = cfg.num_hidden_layers
    reqs = _tp_serve_requests(seed, cfg.vocab_size)
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_serve_")
    fe = FleetFrontend([], chunk_tokens=128, name="chip-tp-serve",
                       peer_read_timeout_s=FLEET_PEER_READ_TIMEOUT_S)
    mgr = LocalProcessManager(fe, model="llama3-8b", chunk_tokens=128,
                              seed=seed, tp=1,
                              extra_args=["--spill-mb", str(TP_SERVE_SPILL_MB),
                                          "--migrate", "on",
                                          "--layers", str(TP_SERVE_LAYERS)],
                              spawn_timeout_s=FLEET_SPAWN_TIMEOUT_S,
                              probe_interval_s=0.25, stale_after_s=10.0,
                              drain_grace_s=60.0, log_dir=log_dir)
    proc = None
    try:
        t0 = time.perf_counter()
        try:
            peer = mgr.spawn()
        except Exception as e:
            for name in os.listdir(log_dir):
                with open(os.path.join(log_dir, name)) as f:
                    log(f"[tp-serve] {name}: ...{f.read()[-3000:]}")
            fail(f"tp-serve (a): the tp replica did not start: {e!r}")
        cold_s = time.perf_counter() - t0
        proc = mgr.procs[peer.name]
        dz0 = _replica_doc(peer, "/debugz")
        seq0 = dz0["replicas"]["r0"]["engine"]["tp_sequencer"]
        rag0, _ = _ragged_of(dz0)
        fl0, _ = _flash_of(dz0)
        steps0 = _decode_steps(_replica_doc(peer, "/healthz"))
        results, wall = asyncio.run(_tp_serve_traffic(fe, reqs))
        dz1 = _replica_doc(peer, "/debugz")
        seq1 = dz1["replicas"]["r0"]["engine"]["tp_sequencer"]
        rag1, rag_routes = _ragged_of(dz1)
        fl1, fl_routes = _flash_of(dz1)
        ticks = _decode_steps(_replica_doc(peer, "/healthz")) - steps0
        ragged, flash = rag1 - rag0, fl1 - fl0
        steps = seq1["steps"] - seq0["steps"]
        per_step = {k: (seq1["host_us"][k] - seq0["host_us"][k])
                    / max(steps, 1)
                    for k in ("record", "broadcast", "apply", "step")}
        pids = seq1["pids"]
        # the SIGTERM drain: the launcher passes it on, rank 0 drains,
        # migrating a live stream (its span banked in the arena and
        # served over /kvz while the drain's grace holds the port open)
        kvz_prompt = torch.randint(
            0, cfg.vocab_size, (TP_SERVE_KVZ_PROMPT,),
            generator=torch.Generator().manual_seed(seed + 63)).tolist()
        t0 = time.perf_counter()
        kvz = asyncio.run(_tp_serve_kvz(peer.port, proc, kvz_prompt))
        mgr.stop_all(grace_s=60.0)
        rc = proc.wait(10)
        drain_s = time.perf_counter() - t0
        alive = [p for p in pids if os.path.exists(f"/proc/{p}")
                 and open(f"/proc/{p}/stat").read().rsplit(")", 1)[1]
                 .split()[0] != "Z"]
        # the direct plain engine on this process's own model
        model = ptt.LlamaForCausalLM(cfg, device=dev,
                                     generator=ptt.make_generator(seed,
                                                                  dev))
        direct = PagedEngine(model, **llama3_8b_engine_kw())
        for r in reqs:
            direct.submit(r["request_id"], torch.as_tensor(r["prompt"]),
                          **{k: v for k, v in r.items()
                             if k not in ("request_id", "prompt")})
        ref = direct.run()
        bad = [r["request_id"] for r in reqs
               if results[r["request_id"]][0] != 200
               or results[r["request_id"]][1].get("finish_reason") != "stop"
               or results[r["request_id"]][2] != ref[r["request_id"]]
               or results[r["request_id"]][1].get("tokens")
               != ref[r["request_id"]]
               or results[r["request_id"]][1].get("logprobs")
               != direct.logprobs[r["request_id"]]]
        ttft = np.array([v[3] for v in results.values() if v[3] is not None])
        new_tokens = sum(len(v[2]) for v in results.values())
        log(f"[tp-serve] (a) replica_main --tp 1 --model llama3-8b --layers "
            f"{L} (of 32; widths kept) --seed {seed} through paddle_tpu_torch.distributed.launch (world-one "
            f"NCCL mesh, the model built sharded and bound once, its engine "
            f"behind the SequencedEngine) up in {cold_s:.1f} s; 9 requests "
            f"through a FleetFrontend (8 greedy sharing a "
            f"{TP_SERVE_PREFIX}-token prefix, 1 sampled; {TP_SERVE_NEW} "
            f"new each): {new_tokens} new tokens in {wall:.2f} s, "
            f"{new_tokens / wall:.1f} new tokens/s; client TTFT p50 "
            f"{np.percentile(ttft, 50):.1f} ms p99 "
            f"{np.percentile(ttft, 99):.1f} ms; streams bit for bit the "
            f"direct plain engine's (tokens and logprobs): "
            f"{len(reqs) - len(bad)} of {len(reqs)} [{card}]")
        log(f"[tp-serve] (a) the sequencer over the traffic: {steps} steps; "
            f"host us a step: record {per_step['record']:.1f}, send "
            f"(encode, decode; no collective at tp 1) "
            f"{per_step['broadcast']:.1f}, apply {per_step['apply']:.1f}, "
            f"the engine's step {per_step['step']:.1f}; "
            f"{seq1['batch_bytes'] - seq0['batch_bytes']} batch bytes "
            f"[{card}]")
        log(f"[tp-serve] (a) the replica's launches over the traffic, read "
            f"from its /debugz: ragged {ragged} = {L} x {ticks} decode "
            f"ticks (by route {rag_routes}), flash {flash} (the engine's "
            f"prefill chunks attend densely; by route {fl_routes}); SIGTERM "
            f"drained it in "
            f"{drain_s:.1f} s: launcher exit {rc}, rank processes left "
            f"{alive} [{card}]")
        if bad:
            fail(f"tp-serve (a): streams differ from the direct plain "
                 f"engine's: {bad}")
        if ragged != L * ticks or not ticks or _taken(rag_routes) != {"mma"}:
            fail(f"tp-serve (a): ragged launches {ragged} in {ticks} ticks "
                 f"(want {L} a tick, on mma: {rag_routes})")
        if flash:
            fail(f"tp-serve (a): flash launches {flash} in the engine's "
                 f"traffic (want 0: its prefill chunks attend densely)")
        if rc != 0 or alive:
            fail(f"tp-serve (a): the drained replica's launcher exited {rc}, "
                 f"rank processes left {alive}")
        launches = {"ragged": ragged}
        launches["ragged"] += _tp_serve_kvz_check(kvz, direct, kvz_prompt,
                                                  card)
        del direct, model
        return launches
    finally:
        mgr.stop_all(grace_s=10.0)
        if proc is not None and proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(10)
        shutil.rmtree(log_dir, ignore_errors=True)


def _tp_serve_loader(seed, dev, card):
    """(b) The 2-layer full-width Llama-3-8B checkpoint loaded whole, then
    inside ``sharded_build`` on a world-one NCCL mesh: every parameter
    bit for bit, each load's seconds and peak card memory."""
    import torch.distributed as dist

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.models import hf_interop
    from paddle_tpu_torch.parallel.sharding import local, sharded_build
    cfg = ptt.llama3_8b(num_hidden_layers=2)
    src = ptt.LlamaForCausalLM(cfg, device=dev,
                               generator=ptt.make_generator(seed + 50, dev))
    tensors = {k: v.detach().cpu().to(torch.bfloat16)
               for k, v in src.state_dict().items()}
    del src
    d = tempfile.mkdtemp(prefix="hf_llama_tp_")
    try:
        nbytes = _write_hf_llama(d, cfg, tensors)
        del tensors

        def load(**kw):
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            m = hf_interop.from_pretrained(d, device=dev)
            torch.cuda.synchronize()
            return (m, time.perf_counter() - t0,
                    (torch.cuda.max_memory_allocated(dev) - base) / 2**30)
        whole, t_whole, peak_whole = load()
        env.init_parallel_env({"tp": 1})
        try:
            with sharded_build(fsdp_min_size=1 << 30):
                per, t_per, peak_per = load()
            want, got = whole.state_dict(), per.state_dict()
            bad = [k for k in want if k not in got
                   or not torch.equal(local(got[k]), want[k])]
            log(f"[tp-serve] (b) from_pretrained of a 2-layer Llama-3-8B "
                f"checkpoint ({nbytes / 1e9:.2f} GB bf16, 2 shards + index): "
                f"whole {t_whole:.1f} s, peak {peak_whole:.2f} GiB above "
                f"what was resident; inside sharded_build on a world-one "
                f"NCCL mesh (every tensor read through the file's memory "
                f"map, a rank's slice at a time) {t_per:.1f} s, peak "
                f"{peak_per:.2f} GiB; parameters bit for bit the whole "
                f"loader's: {len(want) - len(bad)} of {len(want)} [{card}]")
            if bad or set(got) != set(want):
                fail(f"tp-serve (b): per-rank parameters differ from the "
                     f"whole loader's: {bad[:4]}")
        finally:
            env.clear_mesh()
            dist.destroy_process_group()
        del whole, per
    finally:
        shutil.rmtree(d, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def phase_tp_serve(seed, dev, card):
    """Tensor-parallel serving behind the fleet at a world of one
    (``[tp-serve]`` lines): (a) the replica, (b) the per-rank loader.
    Returns the main path's launches."""
    t0 = time.perf_counter()
    launches = _tp_serve_fleet(seed, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    _tp_serve_loader(seed, dev, card)
    log(f"[tp-serve] phase {time.perf_counter() - t0:.1f} s [{card}]")
    return launches



# phase 17: the MoE families and MLA served sharded. ERNIE-4.5-21B-A3B's
# heads a rank at tp 2 and 4 (20 query heads over 4 kv heads)
TP_MOE_HEADS = {"ERNIE tp 2": (10, 2), "ERNIE tp 4": (5, 1)}
# its per-rank projections (label, din of the rank's codes, dout, scale
# blocks of the whole table, the rank whose offset is read): attention
# and the dense layer 0's MLP; the experts are parameters, not
# quantized, in both packages
TP_MOE_QUANT = (("tp 2 q col", 2560, 1280, 20, 0),
                ("tp 2 k/v col", 2560, 256, 20, 0),
                ("tp 2 o row", 1280, 2560, 20, 1),
                ("tp 2 gate/up col", 2560, 6144, 20, 0),
                ("tp 2 down row", 6144, 2560, 96, 1),
                ("tp 4 q col", 2560, 640, 20, 0),
                ("tp 4 k/v col", 2560, 128, 20, 0),
                ("tp 4 o row", 640, 2560, 20, 3),
                ("tp 4 gate/up col", 2560, 3072, 20, 0),
                ("tp 4 down row", 3072, 2560, 96, 3))
# the replica's frontend chunk (its engine prefills whole prompts) and
# its traffic: 8 greedy requests and one sampled, 64 new tokens each
TP_MOE_CHUNK = 128
TP_MOE_NEW = 64


def _tp_moe_requests(seed, vocab):
    import numpy as np
    rs = np.random.RandomState(seed + 80)
    gen = torch.Generator().manual_seed(seed + 81)

    def ids(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()
    reqs = [dict(request_id=f"e{i}", prompt=ids(int(rs.randint(64, 513))),
                 max_new_tokens=TP_MOE_NEW) for i in range(8)]
    reqs.append(dict(request_id="es", prompt=ids(300),
                     max_new_tokens=TP_MOE_NEW, temperature=0.8,
                     top_p=0.95, seed=seed + 82))
    return reqs


def _tp_moe_direct(seed, model):
    """The replica's streams from the plain model: an engine at
    ``replica_main``'s ERNIE geometry, warmed as the replica warms its
    own, then each request of ``_tp_moe_requests`` alone (as the phase
    sends them: an MoE tick's rows share the experts' capacity, so a
    stream depends on what runs beside it). {rid: (tokens, logprobs)}."""
    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.serving.fleet.replica_main import engine_kw, warm
    eng = PagedEngine(model, **engine_kw("ernie45-21b-a3b", TP_MOE_CHUNK))
    warm(eng, TP_MOE_CHUNK)
    out = {}
    for r in _tp_moe_requests(seed, model.config.vocab_size):
        rid = r["request_id"]
        eng.submit(rid, torch.as_tensor(r["prompt"]),
                   **{k: v for k, v in r.items()
                      if k not in ("request_id", "prompt")})
        eng.run()
        out[rid] = (list(eng.results.pop(rid)), list(eng.logprobs.pop(rid)))
    del eng
    return out


def _rank_params(model, tp, ep):
    """Parameters a rank of a ``{"tp": tp, "ep": ep}`` mesh holds of
    ``model``, counted from its partitions as ``shard_layer`` places them
    (a dim split over tp or ep is divided by the degree; the rest whole)."""
    from paddle_tpu_torch.nn.common import partition_of
    deg = {"tp": tp, "ep": ep}
    n = 0
    for p in model.parameters():
        k = p.numel()
        for axes in partition_of(p) or ():
            for a in (axes,) if isinstance(axes, str) else (axes or ()):
                k //= deg.get(a, 1)
        n += k
    return n


def _tp_moe_sharded(seed, dev, card, plain):
    """(a) ERNIE-4.5-21B-A3B built sharded on a world-one ``{"tp": 1,
    "ep": 1}`` mesh and bound once, through ``Predictor.generate`` and the
    ``PagedEngine``, bit for bit phase 11's plain model. Returns the main
    paths' launches."""
    import torch.distributed as dist

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.parallel.sharding import (bind_static, local,
                                                    shard_layer,
                                                    sharded_build)
    cfg = ptt.models.Ernie45MoeConfig(num_hidden_layers=MOE_ERNIE_LAYERS)
    L = cfg.num_hidden_layers
    mesh = env.init_parallel_env({"tp": 1, "ep": 1})
    try:
        t0 = time.perf_counter()
        with sharded_build(fsdp_min_size=1 << 30):
            model = ptt.models.Ernie45MoeForCausalLM(
                cfg, device=dev, generator=ptt.make_generator(seed + 60,
                                                              dev))
        shard_layer(model, fsdp_min_size=1 << 30)
        bound_t = bind_static(model)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        aliased = all(bound_t[n].data_ptr() == local(p).data_ptr()
                      for n, p in model.named_parameters())
        del bound_t
        whole = _rank_params(model, 1, 1)
        per_rank = {f"tp {t} x ep {e}": _rank_params(model, t, e)
                    for t, e in ((2, 2), (4, 1), (2, 1))}
        log(f"[tp-moe] (a) parameters a rank holds, counted from the "
            f"partitions: whole {whole / 1e9:.2f} B ({2 * whole / 1e9:.1f} "
            f"GB bf16); "
            + ", ".join(f"{k} {v / 1e9:.2f} B ({2 * v / 1e9:.1f} GB)"
                        for k, v in per_rank.items())
            + f" [{card}]")
        log(f"[tp-moe] (a) ERNIE-4.5-21B-A3B at full width, cut to {L} "
            f"layers (MOE_CUTS), {cfg.num_experts} experts a MoE layer) from seed "
            f"{seed + 60}, built sharded (sharded_build: each decoder "
            f"layer cut to this rank's shards as drawn) on mesh "
            f"{ {k: v for k, v in mesh.shape.items() if k in ('tp', 'ep')} }"
            f" over {dist.get_backend()} (world {dist.get_world_size()}) "
            f"and bound once in {build_s:.1f} s, "
            f"{_weight_gb(model):.1f} GB; every compute tensor the local "
            f"shard itself: {aliased}; phase 11's plain model was freed "
            f"first [{card}]")
        if not aliased:
            fail("tp-moe (a): a compute tensor is not its local shard")
        pred = ptt.Predictor(model, device=dev)
        ids = plain["ids"].to(dev)
        new = plain["generate"].shape[1] - ids.shape[1]
        want = dict(NO_LAUNCHES, flash=L, decode=L * (new - 1))
        run = _generate_run(ptt, pred, ids, new, want, "tp-moe (a)", dev,
                            card)
        same_gen = torch.equal(run["out"].cpu(), plain["generate"])
        launches = {k: run["launches"][k] for k in ("flash", "decode")}
        del pred
        subs, toks = _moe_engine_subs(seed, cfg.vocab_size)
        eng = PagedEngine(model, **PAGED)
        _serve(eng, subs[:1], late_after=0)         # as phase 11: captures
        steps0 = eng.stats["decode_steps"]
        read = _reset_launches()
        out, wall, _, in_prefill = _serve(eng, subs, late_after=4)
        got = read()
        ticks = eng.stats["decode_steps"] - steps0
        _same_streams("tp-moe (a) engine", out, dict(eng.logprobs),
                      *plain["engine"])
        if got != dict(NO_LAUNCHES, ragged=L * ticks) or in_prefill:
            fail(f"tp-moe (a) engine: launches {got} in {ticks} ticks")
        _check_routes("tp-moe (a) engine", ragged=L * ticks)
        launches["ragged"] = got["ragged"]
        tick_ms = _steady_tick_ms(eng, toks)
        log(f"[tp-moe] (a) generate 4 x 512 + {new} greedy: tokens bit for "
            f"bit phase 11's plain model: {same_gen}; PagedEngine "
            f"({len(subs)} requests, whole-prompt prefill, {ticks} ticks, "
            f"{16 * 64 / wall:.1f} new tokens/s): streams and logprobs bit "
            f"for bit the plain model's; decode step {run['decode_ms']:.2f} "
            f"ms sharded against {plain['decode_ms']:.2f} plain, steady "
            f"tick (16 rows) {tick_ms:.2f} ms against {plain['tick_ms']:.2f}"
            f" [{card}]")
        if not same_gen:
            fail("tp-moe (a): the sharded model's greedy tokens differ from "
                 "the plain model's")
        del eng, model, run
    finally:
        env.clear_mesh()
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def _tp_moe_experts(gen, dev, card):
    """(b) One ERNIE MoE layer's expert products at a decode step's
    capacity (C = 4 for 4 tokens) with E / ep = 64, 32 and 16 experts on
    the rank: the three batched matmuls and the SwiGLU, device time from
    a CUDA graph, beside the bound of reading the rank's experts."""
    import torch.nn.functional as TF
    h, m, C = 2560, 1536, 4
    for El in (64, 32, 16):
        nbytes = 2 * (3 * El * h * m + 2 * El * C * h)
        n = copies_for(nbytes)
        sets = [tuple((torch.randn(*s, generator=gen, device=dev) * 0.02)
                      .to(torch.bfloat16)
                      for s in ((El, C, h), (El, h, m), (El, h, m),
                                (El, m, h))) for _ in range(n)]

        def experts(i):
            x, wg, wu, wd = sets[i % n]
            return torch.bmm(TF.silu(torch.bmm(x, wg)) * torch.bmm(x, wu),
                             wd)
        ms = graph_ms(experts, calls=10)
        b_ms, b_by = bound(nbytes, 2 * 3 * El * C * h * m)
        log(f"[tp-moe] (b) one MoE layer's expert products, E / ep = {El} "
            f"experts of [{h}, {m}] on the rank, C = {C}: {ms:.4f} ms "
            f"(device time, CUDA graph; torch.bmm, as in both packages) "
            f"against the bound {b_ms:.4f} ms ({b_by}) [{card}]")
        del sets


async def _tp_moe_traffic(fe, reqs):
    """Each request through ``fe`` in turn, SSE: {rid: (status, final
    event, tokens, TTFT ms)} and the wall seconds."""
    await fe.start()
    out = {}
    t0 = time.perf_counter()
    for r in reqs:
        units = []
        st, fin, ts = await _sse_timed(fe.port, r, units)
        out[r["request_id"]] = (st, fin or {}, [u[0] for u in units],
                                (units[0][2] - ts) * 1e3 if units else None)
    wall = time.perf_counter() - t0
    await fe.drain()
    return out, wall


def _tp_moe_replica(seed, dev, card, plain):
    """(c) ``replica_main --tp 1 --ep 1 --model ernie45-21b-a3b`` behind a
    FleetFrontend: its streams bit for bit the plain model's engine at its
    geometry, its ragged launches read from its /debugz, drained by
    SIGTERM. Returns the traffic's ragged launches."""
    import asyncio

    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.serving.fleet import (FleetFrontend,
                                                LocalProcessManager)
    cfg = ptt.models.Ernie45MoeConfig(num_hidden_layers=MOE_ERNIE_LAYERS)
    L = cfg.num_hidden_layers
    reqs = _tp_moe_requests(seed, cfg.vocab_size)
    ref = plain["replica"]
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_moe_")
    fe = FleetFrontend([], chunk_tokens=TP_MOE_CHUNK, name="chip-tp-moe",
                       peer_read_timeout_s=FLEET_PEER_READ_TIMEOUT_S)
    mgr = LocalProcessManager(fe, model="ernie45-21b-a3b",
                              chunk_tokens=TP_MOE_CHUNK, seed=seed + 60,
                              tp=1, ep=1, extra_args=[
                                  "--layers", str(MOE_ERNIE_LAYERS)],
                              spawn_timeout_s=FLEET_SPAWN_TIMEOUT_S,
                              probe_interval_s=0.25, stale_after_s=10.0,
                              drain_grace_s=60.0, log_dir=log_dir)
    proc = None
    try:
        t0 = time.perf_counter()
        try:
            peer = mgr.spawn()
        except Exception as e:
            for name in os.listdir(log_dir):
                with open(os.path.join(log_dir, name)) as f:
                    log(f"[tp-moe] {name}: ...{f.read()[-3000:]}")
            fail(f"tp-moe (c): the replica did not start: {e!r}")
        cold_s = time.perf_counter() - t0
        proc = mgr.procs[peer.name]
        dz0 = _replica_doc(peer, "/debugz")
        rag0, _ = _ragged_of(dz0)
        steps0 = _decode_steps(_replica_doc(peer, "/healthz"))
        results, wall = asyncio.run(_tp_moe_traffic(fe, reqs))
        dz1 = _replica_doc(peer, "/debugz")
        seq = dz1["replicas"]["r0"]["engine"]["tp_sequencer"]
        rag1, rag_routes = _ragged_of(dz1)
        ticks = _decode_steps(_replica_doc(peer, "/healthz")) - steps0
        ragged = rag1 - rag0
        pids = seq["pids"]
        t0 = time.perf_counter()
        mgr.stop_all(grace_s=60.0)
        rc = proc.wait(10)
        drain_s = time.perf_counter() - t0
        alive = [p for p in pids if os.path.exists(f"/proc/{p}")
                 and open(f"/proc/{p}/stat").read().rsplit(")", 1)[1]
                 .split()[0] != "Z"]
        bad = [r["request_id"] for r in reqs
               if results[r["request_id"]][0] != 200
               or results[r["request_id"]][1].get("finish_reason") != "stop"
               or (results[r["request_id"]][2],
                   results[r["request_id"]][1].get("logprobs"))
               != tuple(ref[r["request_id"]])]
        ttft = np.array([v[3] for v in results.values() if v[3] is not None])
        new_tokens = sum(len(v[2]) for v in results.values())
        log(f"[tp-moe] (c) replica_main --tp 1 --ep 1 --model "
            f"ernie45-21b-a3b --seed {seed + 60} through the launcher "
            f"(world-one NCCL mesh, built sharded, the SequencedEngine over "
            f"the tp x ep ranks) up in {cold_s:.1f} s (seq pids {pids}); "
            f"{len(reqs)} requests one after another through a "
            f"FleetFrontend ({TP_MOE_NEW} new each, 1 sampled): "
            f"{new_tokens} new tokens in {wall:.2f} s, "
            f"{new_tokens / wall:.1f} new tokens/s; TTFT p50 "
            f"{np.percentile(ttft, 50):.1f} ms p99 "
            f"{np.percentile(ttft, 99):.1f} ms; streams bit for bit the "
            f"plain model's engine (tokens and logprobs): "
            f"{len(reqs) - len(bad)} of {len(reqs)}; ragged {ragged} = {L} "
            f"x {ticks} ticks (by route {rag_routes}); SIGTERM drained it "
            f"in {drain_s:.1f} s: launcher exit {rc}, rank processes left "
            f"{alive} [{card}]")
        if bad:
            fail(f"tp-moe (c): streams differ from the plain engine's: {bad}")
        if ragged != L * ticks or not ticks or _taken(rag_routes) != {"mma"}:
            fail(f"tp-moe (c): ragged launches {ragged} in {ticks} ticks")
        if rc != 0 or alive:
            fail(f"tp-moe (c): the drained replica's launcher exited {rc}, "
                 f"rank processes left {alive}")
        return {"ragged": ragged}
    finally:
        mgr.stop_all(grace_s=10.0)
        if proc is not None and proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(10)
        shutil.rmtree(log_dir, ignore_errors=True)


def _tp_moe_deepseek(seed, dev, card, plain):
    """(d) DeepSeek-V2-Lite's widths (``DSV2_LITE``'s depth) built sharded on a
    world-one mesh through ``generate()``, and the V3-style variant
    through ``mtp_speculative_generate``: bit for bit phase 11's plain
    models."""
    import torch.distributed as dist

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.generation.speculative import \
        mtp_speculative_generate
    from paddle_tpu_torch.parallel.sharding import (bind_static, shard_layer,
                                                    sharded_build)
    ids = plain["ids"].to(dev)
    new = plain["v2_generate"].shape[1] - ids.shape[1]
    env.init_parallel_env({"tp": 1, "ep": 1})
    try:
        def sharded(hf, seed_, **over):
            with sharded_build(fsdp_min_size=1 << 30):
                model, cfg, _, build_s = _deepseek_build(hf, seed_, dev,
                                                         **over)
            shard_layer(model, fsdp_min_size=1 << 30)
            bind_static(model)
            return model, cfg, build_s
        model, cfg, build_s = sharded(DSV2_LITE, seed + 70)
        read = _reset_launches()
        out = ptt.generate(model, ids, ptt.GenerationConfig(
            max_new_tokens=new))
        launches = read()
        same_v2 = torch.equal(out.cpu(), plain["v2_generate"])
        del model, out
        gc.collect()
        torch.cuda.empty_cache()
        model, cfg, build3_s = sharded(DSV3_VARIANT, seed + 72,
                                       num_nextn_predict_layers=1)
        rows = plain["v3_mtp"].shape[0]
        out, stats = mtp_speculative_generate(
            model, ids[:rows], max_new_tokens=new, num_draft_tokens=4,
            return_stats=True)
        same_v3 = torch.equal(out.cpu(), plain["v3_mtp"]) and \
            stats["target_forwards"] == plain["v3_forwards"]
        cache = tuple(model.init_kv_caches(1, 4)[0][0].shape)
        log(f"[tp-moe] (d) DeepSeek-V2-Lite's widths ({cfg.num_hidden_layers}"
            f" layers; {MOE_CUTS}) built sharded on a world-one mesh in "
            f"{build_s:.1f} s: generate 4 x 512 + {new} bit for bit phase "
            f"11's plain model: {same_v2} (launches {launches}: MLA's "
            f"absorbed decode is einsums in both packages); the V3-style "
            f"variant (one MTP module) built sharded in {build3_s:.1f} s: "
            f"mtp_speculative_generate ({rows} rows) bit for bit, target "
            f"forwards equal: {same_v3}; a rank's latent cache a layer "
            f"{cache} (whole: MLA's cache has no heads to split) [{card}]")
        if not (same_v2 and same_v3):
            fail("tp-moe (d): a sharded DeepSeek stream differs from the "
                 "plain model's")
        if launches != NO_LAUNCHES:
            fail(f"tp-moe (d): launches {launches}")
        del model, out
    finally:
        env.clear_mesh()
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


def phase_tp_moe(seed, gen, dev, card, plain):
    """The MoE families and MLA served sharded (``[tp-moe]`` lines): (a)
    ERNIE built sharded at a world of one through generate and the
    engine, (b) the kernels at ERNIE's per-rank shapes and the expert
    products, (c) an ERNIE replica behind the fleet, (d) DeepSeek built
    sharded. ``plain``: phase 11's plain models' streams. Returns the
    main paths' launches."""
    t0 = time.perf_counter()
    launches = _tp_moe_sharded(seed, dev, card, plain)
    _tp_attention(gen, dev, card, heads=TP_MOE_HEADS, tag="[tp-moe] (b)")
    _tp_quant(gen, dev, card, table=TP_MOE_QUANT, bits_set=(8,),
              tag="[tp-moe] (b)")
    _tp_moe_experts(gen, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches["ragged"] += _tp_moe_replica(seed, dev, card, plain)["ragged"]
    _tp_moe_deepseek(seed, dev, card, plain["deepseek"])
    log(f"[tp-moe] phase {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


# ------------------------------------------------------------ fine-tuning
FT_LORA = dict(r=8, lora_alpha=16,
               target_modules=[".*q_proj", ".*k_proj", ".*v_proj",
                               ".*o_proj", ".*gate_proj", ".*up_proj",
                               ".*down_proj"])
FT_ROWS, FT_LEN = 2, 2048          # packed SFT rows of [2, 2048]
FT_EXAMPLE = (16, 512)             # tokens of one prompt/response pair
FT_STEPS = 3
FT_LR = 1e-3
FT_GRAD_LAYERS = 2                 # depth of (c)'s kernels-vs-plain step
DPO_SEQ, DPO_PROMPT, DPO_STEPS = 1024, 256, 3   # step 0, then 2 more
FT_NEW = 32                        # generate()'s new tokens in (e), (f)
FT_PROMPT = (2, 512)
PTQ_CALIB = (2, (1, 512))          # calibration batches of [1, 512]
QAT_STEPS = 2
# DPO's step-0 loss: the reference log-probs are the policy's own (B = 0,
# the same [2, 1024] forward), so the loss is ln 2 up to the fp32 sums
TOL_LN2 = 1e-3
# (b) a packed row's segment logits against the segment's own forward,
# max |d| over max |ref|: the two forwards round the same bf16
# activations through other GEMM shapes (2048 against <= 512 rows) and
# flash tilings (with and without segments) over 32 layers, ~2^-8 a
# layer; a leak across segments or a position off by one moves the
# logits by O(1) of their scale
TOL_PACKED = 2.0 ** -4
# (e) the merged model's logits against the adapted one's (W + BA rounded
# to bf16 once against x W and x A B rounded apart), max |d| / max |ref|
TOL_MERGE = 2.0 ** -4
# (e) unmerge: W' = bf16(bf16(W + d) - d), two roundings of half a bf16
# step of |W + d| each: within 2^-7 max |W| of a tensor; 2^-6 leaves d's
# share
TOL_UNMERGE = 2.0 ** -6
# (f) W8A8 logits with the quant kernel against the kernel's plain
# version: one bf16 step of a projection's output (2^-7, TOL_QUANT_REL),
# carried through 32 layers, as (b)
TOL_PTQ_PLAIN = 2.0 ** -4


def _ft_examples(rs, vocab, rows, length):
    """Seeded prompt/response pairs of FT_EXAMPLE tokens (a quarter
    prompt), as many as ``DataCollatorForSFT(packing=True, pack_rows=
    rows)`` packs into ``rows`` rows of ``length``: (examples, batch)."""
    from paddle_tpu_torch.trl import DataCollatorForSFT
    coll = DataCollatorForSFT(max_length=length, packing=True,
                              pack_rows=rows)
    ex = []
    while True:
        n = int(rs.randint(FT_EXAMPLE[0], FT_EXAMPLE[1] + 1))
        p = max(1, n // 4)
        cand = ex + [{"prompt_ids": rs.randint(1, vocab, p).tolist(),
                      "response_ids": rs.randint(1, vocab, n - p).tolist()}]
        try:
            coll(cand)
        except ValueError:
            return ex, coll(ex)
        ex = cand


def _segment_pairs(seg, heads):
    """(query, key) pairs the segment kernels attend for ``seg`` [b, s]:
    causal pairs inside each run of one id (the pad id 0 included: it is
    a segment to the kernel), times the heads."""
    pairs = 0
    for row in seg.tolist():
        run = 1
        for i in range(1, len(row) + 1):
            if i < len(row) and row[i] == row[i - 1]:
                run += 1
                continue
            pairs += run * (run + 1) // 2
            run = 1
    return pairs * heads


def _ft_segment_kernels(gen, dev, card, seg):
    """The flash forward, dq and dk/dv with this batch's packed segment ids
    at [2, 2048, 32 / 8, 128] bf16 causal: each against its plain version
    (TOL_BF16 for the output, TOL_BWD_BF16 x max|ref| for the gradients),
    on the wgmma route, then timed beside the plain versions, SDPA with
    the same boolean mask (forward, and its backward for dq, dk and dv)
    and the bound of this data's (query, key) pairs. Returns the errors
    by kernel key."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels.flash_attention import (
        _delta, flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
        flash_attention_bwd_dq, flash_attention_bwd_dq_plain,
        flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    b, s = seg.shape
    h, kv, d = 32, 8, 128
    scale = 1.0 / d ** 0.5
    seg = seg.to(dev, torch.int32)
    sets = []
    for _ in range(2):         # two sets: one call's inputs exceed the L2
        q, k, v, g, _ = _bwd_inputs(gen, dev, torch.bfloat16, b, s, h, kv,
                                    d)
        sets.append((q, k, v, g))
    read = _reset_launches()
    q, k, v, g = sets[0]
    out, lse = flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)
    delta = _delta(out, g)
    kw = dict(causal=True, scale=scale, window=None)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, seg, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, seg, **kw)
    torch.cuda.synchronize()
    got = read()
    _check_routes("finetune seg kernels", flash=1, flash_bwd_dq=1,
                  flash_bwd_dkv=1)
    ref_out, _ = flash_attention_fwd_plain(q, k, v, causal=True,
                                           segment_ids=seg)
    errs = {"flash": max_err(out, ref_out)}
    refs = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True,
                                     segment_ids=seg)
    line = [f"out {errs['flash']:.3e} (tol {TOL_BF16})"]
    if not errs["flash"] <= TOL_BF16:
        fail(f"finetune: the flash forward with segments disagrees with "
             f"its plain version at {[b, s]}")
    for name, a, r in (("dq", dq, refs[0]), ("dk", dk, refs[1]),
                       ("dv", dv, refs[2])):
        err, rmax = max_err(a, r), float(r.float().abs().max())
        key = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
        errs[key] = max(errs.get(key, 0.0), err)
        line.append(f"{name} {err:.3e} (max|ref| {rmax:.3e})")
        if not err <= TOL_BWD_BF16 * rmax:
            fail(f"finetune: flash backward {name} with segments disagrees "
                 f"with its plain version at {[b, s]}")
    nseg = [len(set(r) - {0}) for r in seg.tolist()]
    log(f"[finetune] flash kernels with this batch's segment ids ({nseg} "
        f"segments a row, pad tail as id 0) at q {[b, s, h, d]} kv "
        f"{[b, s, kv, d]} bf16 causal, launches {got['flash']}/"
        f"{got['flash_bwd_dq']}/{got['flash_bwd_dkv']} on wgmma, against "
        f"the plain versions: " + ", ".join(line)
        + f" (gradients: tol {TOL_BWD_BF16} x max|ref|)")
    del out, lse, delta, dq, dk, dv, ref_out, refs

    fwd = [flash_attention_fwd(*t[:3], causal=True, segment_ids=seg)
           for t in sets]
    deltas = [_delta(o, t[3]) for (o, _), t in zip(fwd, sets)]
    keep = (torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None]
            & (seg[:, :, None] == seg[:, None, :]))[:, None]
    lib_in = [tuple(x.transpose(1, 2).contiguous().requires_grad_()
                    for x in t[:3]) for t in sets]
    lib_out = [TF.scaled_dot_product_attention(
        x[0], *[y.repeat_interleave(h // kv, 1) for y in x[1:]],
        attn_mask=keep) for x in lib_in]
    lib_g = [t[3].transpose(1, 2).contiguous() for t in sets]
    times = {}
    times["flash"] = dict(
        ms=cuda_ms(lambda i: flash_attention_fwd(
            *sets[i % 2][:3], causal=True, segment_ids=seg), iters=20),
        plain_ms=cuda_ms(lambda i: flash_attention_fwd_plain(
            *sets[i % 2][:3], causal=True, segment_ids=seg), iters=3,
            warmup=1),
        library_ms=cuda_ms(lambda i: TF.scaled_dot_product_attention(
            lib_in[i % 2][0], *[y.repeat_interleave(h // kv, 1)
                                for y in lib_in[i % 2][1:]],
            attn_mask=keep), iters=10))

    def bargs(i):
        (q, k, v, g), (_, lse) = sets[i % 2], fwd[i % 2]
        return (q, k, v, g, lse, deltas[i % 2], seg)
    def pargs(i):
        (q, k, v, g), (out, lse) = sets[i % 2], fwd[i % 2]
        return (q, k, v, out, lse, g)
    times["flash_bwd_dq"] = dict(
        ms=cuda_ms(lambda i: flash_attention_bwd_dq(*bargs(i), **kw),
                   iters=10),
        plain_ms=cuda_ms(lambda i: flash_attention_bwd_dq_plain(
            *pargs(i), causal=True, segment_ids=seg), iters=3, warmup=1),
        library_ms=cuda_ms(lambda i: torch.autograd.grad(
            lib_out[i % 2], [lib_in[i % 2][0]], lib_g[i % 2],
            retain_graph=True), iters=5))
    times["flash_bwd_dkv"] = dict(
        ms=cuda_ms(lambda i: flash_attention_bwd_dkv(*bargs(i), **kw),
                   iters=10),
        plain_ms=cuda_ms(lambda i: flash_attention_bwd_dkv_plain(
            *pargs(i), causal=True, segment_ids=seg), iters=3, warmup=1),
        library_ms=cuda_ms(lambda i: torch.autograd.grad(
            lib_out[i % 2], list(lib_in[i % 2][1:]), lib_g[i % 2],
            retain_graph=True), iters=5))
    pairs = _segment_pairs(seg, h)
    q_bytes, kv_bytes = 2 * b * s * h * d, 2 * b * s * kv * d
    rows_b, seg_b = 4 * b * h * s, 4 * b * s
    for key, nbytes, products in (
            ("flash", 2 * q_bytes + 2 * kv_bytes + rows_b + seg_b, 2),
            ("flash_bwd_dq", 3 * q_bytes + 2 * kv_bytes + 2 * rows_b + seg_b,
             3),
            ("flash_bwd_dkv", 2 * q_bytes + 4 * kv_bytes + 2 * rows_b
             + seg_b, 4)):
        times[key]["bound_ms"], times[key]["bound_by"] = bound(
            nbytes, products * 2 * d * pairs)
    log(f"[finetune] segment kernels at {[b, s]} (this batch's "
        f"{pairs / (b * h * s * (s + 1) / 2):.3f} of the causal pairs), "
        f"kernel / plain / sdpa with the mask / bound ms: "
        + "; ".join(f"{k} {t['ms']:.4f} / {t['plain_ms']:.4f} / "
                    f"{t['library_ms']:.4f} / {t['bound_ms']:.4f} "
                    f"({t['bound_by']})" for k, t in times.items())
        + f" [{card}]")
    del sets, fwd, deltas, lib_in, lib_out, lib_g, keep
    gc.collect()
    torch.cuda.empty_cache()
    return errs


def _ft_sft(model, batch, dev, card):
    """(a): FT_STEPS SFTTrainer steps on the one packed batch, the counts
    set to 0 just before and read just after. Returns (launches, the
    trainer, the step ms)."""
    import numpy as np

    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.models.llama as llama
    from paddle_tpu_torch.ops.kernels.fused_adam import fused_adam
    from paddle_tpu_torch.peft import lora_state_dict
    from paddle_tpu_torch.trl import SFTTrainer

    class Clock(ptt.TrainerCallback):
        def __init__(self):
            self.t = []

        def on_step_end(self, step, logs):
            self.t.append(time.perf_counter())

    L = model.config.num_hidden_layers
    clock = Clock()
    opt = ptt.optimizer.AdamW(learning_rate=FT_LR, multi_precision=True)
    args = ptt.TrainingArguments(output_dir="output/chip_smoke_finetune",
                                 max_steps=FT_STEPS, logging_steps=1,
                                 prefetch_depth=0)
    tr = SFTTrainer(model, opt, args, train_dataloader=[batch],
                    callbacks=[clock])
    seg_calls = [0, 0]
    real = llama.flash_attention

    def spy(q, k, v, causal=False, scale=None, segment_ids=None,
            window=None):
        seg_calls[segment_ids is not None] += 1
        return real(q, k, v, causal=causal, scale=scale,
                    segment_ids=segment_ids, window=window)
    llama.flash_attention = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    read = _reset_launches()
    clock.t = [time.perf_counter()]
    try:
        tr.train()
        torch.cuda.synchronize()
    finally:
        llama.flash_attention = real
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    want = dict(NO_LAUNCHES, flash=L * FT_STEPS, flash_bwd_dq=L * FT_STEPS,
                flash_bwd_dkv=L * FT_STEPS, fused_adamw=FT_STEPS)
    losses = [v for _, v in tr.logger.history["loss"]]
    n_train = sum(p.numel() for p in lora_state_dict(model).values())
    n_all = sum(p.numel() for p in model.parameters())
    log(f"[finetune] (a) launches in {FT_STEPS} SFT steps: {launches} "
        f"(want {want}); flash calls with segment ids {seg_calls[1]}, "
        f"without {seg_calls[0]}; losses "
        + ", ".join(f"{x:.4f}" for x in losses))
    if launches != want:
        fail(f"finetune: SFT launches {launches} != {want}")
    if seg_calls != [0, L * FT_STEPS]:
        fail(f"finetune: {seg_calls[0]} flash calls of the packed step "
             f"had no segment ids")
    _check_routes("finetune sft", flash=L * FT_STEPS,
                  flash_bwd_dq=L * FT_STEPS, flash_bwd_dkv=L * FT_STEPS)
    slots = tr._opt_state["slots"]
    if set(slots) != set(lora_state_dict(model)) or \
            fused_adam.launches_by_route != {"simt": FT_STEPS}:
        fail("finetune: the optimizer holds state for other parameters "
             "than the adapters, or the update launched otherwise")
    if not (len(losses) == FT_STEPS and all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        fail(f"finetune: the SFT loss did not fall: {losses}")
    steps_ms = np.diff(clock.t) * 1e3
    step_ms = float(np.median(steps_ms[1:]))
    seg = batch["segment_ids"]
    real_tokens = int((seg > 0).sum())
    tokens = seg.numel()
    log(f"[finetune] (a) LoRA SFT at 32 layers, packed [{FT_ROWS}, "
        f"{FT_LEN}] ({real_tokens} of {tokens} positions real, "
        f"{[len(set(r) - {0}) for r in seg.tolist()]} segments a row): "
        f"trainable {n_train} of {n_all} parameters "
        f"({100 * n_train / n_all:.3f} %); step ms (host clock, loss "
        f"synced) " + ", ".join(f"{x:.1f}" for x in steps_ms)
        + f"; median of steps 2-{FT_STEPS} {step_ms:.1f} ms, "
        f"{tokens / (step_ms / 1e3):.0f} tokens/s "
        f"({real_tokens / (step_ms / 1e3):.0f} real); peak memory "
        f"{peak:.2f} GB [{card}]")
    return launches, tr, step_ms


def _ft_packed_vs_lone(model, batch, dev):
    """(b): each segment of each packed row against its forward alone (the
    segment padded on the right to whole 128-row tiles, so it takes the
    flash route too; causal, so the pad changes none of its logits)."""
    from paddle_tpu_torch.trl import packed_sft_inputs
    L = model.config.num_hidden_layers
    ids = batch["input_ids"].to(dev)
    seg = batch["segment_ids"].to(dev)
    model.eval()
    worst, agree, total, n = 0.0, 0, 0, 0
    read = _reset_launches()
    with torch.inference_mode():
        for r in range(ids.shape[0]):
            pos, _ = packed_sft_inputs(seg[r:r + 1], with_mask=False)
            packed = model(ids[r:r + 1], positions=pos,
                           segment_ids=seg[r:r + 1])[0]
            for sid in sorted(set(seg[r].tolist()) - {0}):
                where = (seg[r] == sid).nonzero()[:, 0]
                a, e = int(where[0]), int(where[-1]) + 1
                padded = -(-(e - a) // 128) * 128
                lone_ids = torch.zeros(1, padded, dtype=ids.dtype,
                                       device=dev)
                lone_ids[0, :e - a] = ids[r, a:e]
                lone = model(lone_ids)[0, :e - a]
                rel = max_err(packed[a:e], lone) / max(
                    float(lone.abs().max()), 1e-30)
                worst = max(worst, rel)
                agree += int((packed[a:e].argmax(-1)
                              == lone.argmax(-1)).sum())
                total += e - a
                n += 1
            del packed
    torch.cuda.synchronize()
    got = read()
    model.train()
    log(f"[finetune] (b) {n} segments of the packed rows against their "
        f"forwards alone: max |packed - lone| / max |lone| {worst:.3e} "
        f"(tol {TOL_PACKED:.4g}); argmax equal at {agree} of {total} "
        f"positions; flash launches {got['flash']} (want "
        f"{L * (ids.shape[0] + n)}: the packed rows with segments, the lone "
        f"segments without)")
    if not worst <= TOL_PACKED:
        fail("finetune: a packed segment's logits differ from its forward "
             "alone")
    if got["flash"] != L * (ids.shape[0] + n):
        fail(f"finetune: (b) flash launches {got['flash']} != "
             f"{L * (ids.shape[0] + n)}")
    _check_routes("finetune packed", flash=L * (ids.shape[0] + n))


def _ft_grads(seed, batch, dev):
    """(c): one step's adapter gradients on the kernels against the same
    step on their plain versions (``FlashAttentionFunction`` with
    ``flash_attention_fwd_plain`` and ``flash_attention_bwd_plain``, the
    kernels' rounding points), at full width and FT_GRAD_LAYERS layers, B
    drawn nonzero so every adapter has a gradient."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.peft import LoRAConfig, apply_lora, lora_state_dict
    from paddle_tpu_torch.trl import _make_sft_loss
    model = _train_model(seed + 40, dev, layers=FT_GRAD_LAYERS)
    apply_lora(model, LoRAConfig(**FT_LORA), ptt.make_generator(seed + 41,
                                                                dev))
    g = torch.Generator(device=dev).manual_seed(seed + 42)
    with torch.no_grad():
        for k, v in lora_state_dict(model).items():
            if k.endswith("lora_B"):
                v.copy_(torch.randn(v.shape, generator=g, device=dev) * 0.02)
    names = list(lora_state_dict(model))
    params = list(lora_state_dict(model).values())
    b = {k: v.to(dev) for k, v in batch.items()}
    loss_fn = _make_sft_loss(True)
    read = _reset_launches()
    loss_k = loss_fn(model, b)
    grads_k = torch.autograd.grad(loss_k, params)
    torch.cuda.synchronize()
    got = read()
    L = FT_GRAD_LAYERS
    _check_routes("finetune grads", flash=L, flash_bwd_dq=L,
                  flash_bwd_dkv=L)

    real = fa.flash_attention_fwd, fa.flash_attention_bwd
    fa.flash_attention_fwd = fa.flash_attention_fwd_plain
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain
    try:
        loss_p = loss_fn(model, b)
        grads_p = torch.autograd.grad(loss_p, params)
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = real
    rels = sorted((_rel_l2(a, r), n) for a, r, n in zip(grads_k, grads_p,
                                                         names))
    log(f"[finetune] (c) {len(params)} adapter gradients of one packed SFT "
        f"step at full width, {L} layers, kernels (launches {got}) against "
        f"their plain versions: loss {float(loss_k.detach()):.6f} vs "
        f"{float(loss_p.detach()):.6f}; |g - g_plain| / |g_plain| median "
        f"{rels[len(rels) // 2][0]:.3e}, worst {rels[-1][0]:.3e} "
        f"({rels[-1][1]}) (tol {TOL_GRAD_REL})")
    if not rels[-1][0] <= TOL_GRAD_REL:
        fail("finetune: an adapter gradient on the kernels disagrees with "
             "the plain version")
    del model, params, grads_k, grads_p, loss_k, loss_p
    gc.collect()
    torch.cuda.empty_cache()


def _ft_dpo(seed, model, dev, card):
    """(d): B zeroed, the reference log-probs by compute_sequence_logps of
    the same model over the concatenated [2, DPO_SEQ] pair (the forward
    the DPO step runs), then DPOTrainer for DPO_STEPS steps with the
    counts set to 0 just before the reference and read after the last
    step. Returns the launches."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.peft import lora_state_dict
    from paddle_tpu_torch.trl import DPOTrainer, compute_sequence_logps
    L = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    with torch.no_grad():
        for k, v in lora_state_dict(model).items():
            if k.endswith("lora_B"):
                v.zero_()
    rs = np.random.RandomState(seed + 50)
    chosen, rejected = (torch.as_tensor(rs.randint(0, vocab, (1, DPO_SEQ)),
                                        device=dev) for _ in range(2))
    mask = torch.ones(1, DPO_SEQ, dtype=torch.long, device=dev)
    mask[:, :DPO_PROMPT] = 0
    model.train()
    read = _reset_launches()
    ref = compute_sequence_logps(model, torch.cat([chosen, rejected]),
                                 torch.cat([mask, mask]), batch_size=2)
    batch = {"chosen_ids": chosen, "chosen_mask": mask,
             "rejected_ids": rejected, "rejected_mask": mask,
             "ref_chosen_logps": ref[:1], "ref_rejected_logps": ref[1:]}
    t = []

    class Clock(ptt.TrainerCallback):
        def on_step_end(self, step, logs):
            t.append(time.perf_counter())
    tr = DPOTrainer(model, ptt.optimizer.AdamW(learning_rate=FT_LR,
                                               multi_precision=True),
                    ptt.TrainingArguments(
                        output_dir="output/chip_smoke_dpo",
                        max_steps=DPO_STEPS, logging_steps=1,
                        prefetch_depth=0),
                    beta=0.1, train_dataloader=[batch], callbacks=[Clock()])
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    tr.train()
    torch.cuda.synchronize()
    launches = read()
    losses = [v for _, v in tr.logger.history["loss"]]
    want = dict(NO_LAUNCHES, flash=L * (1 + DPO_STEPS),
                flash_bwd_dq=L * DPO_STEPS, flash_bwd_dkv=L * DPO_STEPS,
                fused_adamw=DPO_STEPS)
    steps_ms = np.diff(t) * 1e3
    log(f"[finetune] (d) DPO on a chosen/rejected pair of {DPO_SEQ} tokens "
        f"({DPO_SEQ - DPO_PROMPT} scored) as one [2, {DPO_SEQ}] forward, "
        f"reference log-probs {[round(float(x), 3) for x in ref]}: losses "
        + ", ".join(f"{x:.6e}" for x in losses)
        + f" (step 0 - ln 2 = {losses[0] - np.log(2.0):.2e}, tol "
        f"{TOL_LN2}); step ms " + ", ".join(f"{x:.1f}" for x in steps_ms)
        + f"; launches {launches} (want {want}) [{card}]")
    if launches != want:
        fail(f"finetune: DPO launches {launches} != {want}")
    _check_routes("finetune dpo", flash=L * (1 + DPO_STEPS),
                  flash_bwd_dq=L * DPO_STEPS, flash_bwd_dkv=L * DPO_STEPS)
    if not abs(losses[0] - np.log(2.0)) <= TOL_LN2:
        fail(f"finetune: DPO's step-0 loss {losses[0]} is not ln 2")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"finetune: the DPO loss did not fall: {losses}")
    del tr, batch
    return launches


def _ft_merge(seed, model, base, dev, card):
    """(e): generate() on the adapted model (its step captured with the
    adapters' hooks), merge_lora, generate() again with the counts set to
    0 just before and read just after: the step program is rebuilt (a
    new graph, without the adapters' products), each greedy token is
    within TOL_TEACHER of a teacher-forced forward's maximum, the
    prefill's logits within TOL_MERGE of the adapted model's; then
    unmerge_lora brings every projection back within TOL_UNMERGE of the
    host copy ``base``. Returns (launches, predictor, merged stream)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.peft import merge_lora, unmerge_lora
    L = model.config.num_hidden_layers
    b, prompt = FT_PROMPT
    ids = torch.randint(0, model.config.vocab_size, (b, prompt), device=dev,
                        generator=ptt.make_generator(seed + 60, dev))
    pred = ptt.Predictor(model, device=dev)
    greedy = ptt.GenerationConfig(max_new_tokens=FT_NEW)
    match = lambda k: k[:4] == ("generate", b, prompt + FT_NEW, False)  # noqa: E731
    with torch.inference_mode():
        adapted = model(ids)[:, -1].float()
    out_a = pred.generate(ids, config=greedy)
    prog_a = _step_program(model, match, "finetune merge")
    nodes_a = len(graph_nodes(prog_a.step.graph.graph)[0])
    merge_lora(model)
    pred.generate(ids, config=greedy)          # recaptures: the warm-up
    read = _reset_launches()
    t0 = time.perf_counter()
    out_m = pred.generate(ids, config=greedy)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    launches = read()
    want = dict(NO_LAUNCHES, flash=L, decode=L * (FT_NEW - 1))
    _check_routes("finetune merge", flash=L, decode=L * (FT_NEW - 1))
    prog_m = _step_program(model, match, "finetune merge")
    nodes_m = len(graph_nodes(prog_m.step.graph.graph)[0])
    with torch.inference_mode():
        merged = model(ids)[:, -1].float()
    gaps = [_teacher_gap(model, ids[r].tolist(), out_m[r, prompt:].tolist())
            for r in range(b)]
    rel = max_err(merged, adapted) / float(adapted.abs().max())
    same = int((out_m[:, prompt:] == out_a[:, prompt:]).sum())
    log(f"[finetune] (e) merge_lora: generate {b} x {prompt} + {FT_NEW} "
        f"in {gen_ms:.1f} ms, launches {launches} (want {want}); the step "
        f"program rebuilt: {prog_m is not prog_a} ({nodes_a} kernel nodes "
        f"with the adapters' products, {nodes_m} merged); teacher-forced "
        f"gaps {[round(x, 4) for x in gaps]} (tol {TOL_TEACHER}); prefill "
        f"logits merged vs adapted max |d| / max |ref| {rel:.3e} (tol "
        f"{TOL_MERGE:.4g}); new tokens equal to the adapted stream's "
        f"{same} of {b * FT_NEW} [{card}]")
    if launches != want:
        fail(f"finetune: merged generate launches {launches} != {want}")
    if prog_m is prog_a or not nodes_m < nodes_a:
        fail("finetune: the merge did not rebuild the captured step")
    if not (max(gaps) <= TOL_TEACHER and rel <= TOL_MERGE):
        fail("finetune: the merged model disagrees with the adapted one")
    del prog_a, prog_m
    unmerge_lora(model)
    worst, name_w = 0.0, None
    for name, p in model.named_parameters():
        if name in base and "proj" in name:
            w0 = base[name].to(dev)
            r = max_err(p, w0) / float(w0.float().abs().max())
            if r > worst:
                worst, name_w = r, name
    log(f"[finetune] (e) unmerge_lora: every projection weight back within "
        f"max |W' - W| / max |W| {worst:.3e} ({name_w}; tol "
        f"{TOL_UNMERGE:.4g}, the bf16 round trip)")
    if not worst <= TOL_UNMERGE:
        fail("finetune: unmerge did not restore the base weights")
    return launches, pred, out_m


def _ft_ptq(seed, model, pred, stream, dev, card):
    """(f): merge, the bf16 teacher-forced logits of ``stream``'s first
    row, PTQ (2 calibration batches of [1, 512], lm_head skipped),
    convert, then generate() with the counts set to 0 just before and
    read just after (the quant kernel 7 a layer and decode step, on
    mma); the converted model's logits on the quant kernel against its
    plain version; the teacher-forced gap against bf16. Returns the
    launches."""
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.quant.weight_only as wo
    from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul_plain
    from paddle_tpu_torch.peft import merge_lora
    from paddle_tpu_torch.quant import PTQ, W8A8Linear
    L = model.config.num_hidden_layers
    b, prompt = FT_PROMPT
    merge_lora(model)
    tf = stream[:1]
    with torch.inference_mode():
        ref = model(tf)[0, prompt - 1:-1].float()
    n_calib, shape = PTQ_CALIB
    g = ptt.make_generator(seed + 70, dev)
    ptq = PTQ(model, skip=["lm_head"])
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(n_calib):
            model(torch.randint(0, model.config.vocab_size, shape,
                                device=dev, generator=g))
    calib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptq.convert()
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    n_q = sum(isinstance(m, W8A8Linear) for m in model.modules())
    if n_q != QUANT_PER_LAYER * L:
        fail(f"finetune: PTQ converted {n_q} layers, want "
             f"{QUANT_PER_LAYER * L}")
    ids = stream[:, :prompt]
    greedy = ptt.GenerationConfig(max_new_tokens=FT_NEW)
    pred.generate(ids, config=greedy)          # warm-up: captures the step
    read = _reset_launches()
    t0 = time.perf_counter()
    out = pred.generate(ids, config=greedy)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    launches = read()
    want = dict(NO_LAUNCHES, flash=L, decode=L * (FT_NEW - 1),
                quant=QUANT_PER_LAYER * L * (FT_NEW - 1))
    _check_routes("finetune ptq", flash=L, decode=L * (FT_NEW - 1),
                  quant=QUANT_PER_LAYER * L * (FT_NEW - 1))
    log(f"[finetune] (f) PTQ: {n_calib} calibration batches of "
        f"{list(shape)} in {calib_s:.2f} s, {n_q} W8A8Linear in "
        f"{convert_s:.2f} s (weights {_weight_gb(model):.2f} GB); generate "
        f"{b} x {prompt} + {FT_NEW} in {gen_ms:.1f} ms, launches {launches} "
        f"(want {want}) [{card}]")
    if launches != want:
        fail(f"finetune: PTQ generate launches {launches} != {want}")
    with torch.inference_mode():
        w8 = model(tf)[0, prompt - 1:-1].float()
        x = tf[:, :32]                 # 32 rows: the quant kernel's route
        got = model(x).float()
        real = wo.quant_matmul
        wo.quant_matmul = (lambda x2, qw, sc, bits, block_offset=0:
                           quant_matmul_plain(x2, qw, sc, bits))
        try:
            plain = model(x).float()
        finally:
            wo.quant_matmul = real
    rel = max_err(got, plain) / float(plain.abs().max())
    toks = tf[0, prompt:]
    nll = [float(-torch.log_softmax(lg, -1).gather(1, toks[:, None]).mean())
           for lg in (ref, w8)]
    same = int((out[:, prompt:] == stream[:, prompt:]).sum())
    log(f"[finetune] (f) W8A8 on the quant kernel vs its plain version, "
        f"logits of a [1, 32] forward: max |d| / max |ref| {rel:.3e} (tol "
        f"{TOL_PTQ_PLAIN:.4g}); teacher-forced over the merged bf16 "
        f"model's {FT_NEW} greedy tokens: max |logit W8A8 - bf16| "
        f"{max_err(w8, ref):.3e} (max |bf16| {float(ref.abs().max()):.3e}), "
        f"NLL a token bf16 {nll[0]:.4f} vs W8A8 {nll[1]:.4f}, argmax "
        f"equal at {int((w8.argmax(-1) == ref.argmax(-1)).sum())} of "
        f"{FT_NEW}; W8A8 greedy tokens equal to bf16's {same} of "
        f"{b * FT_NEW} [{card}]")
    if not rel <= TOL_PTQ_PLAIN:
        fail("finetune: W8A8 on the quant kernel disagrees with its plain "
             "version")
    return launches


def _ft_qat(seed, dev, card):
    """(g): the [train] cut (4 layers, [2, 2048]) with every projection in
    a FakeQuantLinear, QAT_STEPS Trainer steps (the training slice's
    AdamW), the counts set to 0 just before and read just after."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nn.common import Linear
    from paddle_tpu_torch.quant import FakeQuantLinear
    model = _train_model(seed, dev)
    n = 0
    for layer in model.model.layers:
        for mod in (layer.self_attn, layer.mlp):
            for name, sub in list(mod.named_children()):
                if isinstance(sub, Linear):
                    setattr(mod, name, FakeQuantLinear(sub))
                    n += 1
    rs = np.random.RandomState(seed + 80)
    batches = [rs.randint(0, model.config.vocab_size, TRAIN_BATCH)]
    t = []

    class Clock(ptt.TrainerCallback):
        def on_step_end(self, step, logs):
            t.append(time.perf_counter())
    tr = _trainer(model, batches, QAT_STEPS, Clock(), prefetch_depth=0,
                  output_dir="output/chip_smoke_qat")
    L = model.config.num_hidden_layers
    torch.cuda.synchronize()
    read = _reset_launches()
    t.append(time.perf_counter())
    tr.train()
    torch.cuda.synchronize()
    launches = read()
    losses = [v for _, v in tr.logger.history["loss"]]
    want = dict(NO_LAUNCHES, flash=L * QAT_STEPS,
                flash_bwd_dq=L * QAT_STEPS, flash_bwd_dkv=L * QAT_STEPS,
                fused_adamw=QAT_STEPS)
    log(f"[finetune] (g) QAT: {n} FakeQuantLinear (int8 weights per output "
        f"channel, straight-through) at the [train] cut ({L} layers, "
        f"{list(TRAIN_BATCH)}): step ms "
        + ", ".join(f"{x:.1f}" for x in np.diff(t) * 1e3)
        + f" (step 1 with its warm-up); losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; launches {launches} (want {want}) [{card}]")
    if launches != want:
        fail(f"finetune: QAT launches {launches} != {want}")
    if not all(np.isfinite(losses)):
        fail("finetune: a QAT loss is not finite")
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _ft_decode_quant_times(gen, dev, card):
    """Rows 4 and 7 at this phase's generate(): decode one query a row of
    [2, 32, 128] over a [2, 544, 8, 128] cache at the last position (a
    device index), and the int8 quant kernel at m = 2 on the four
    projection shapes, each as device time from a CUDA graph of
    back-to-back calls, beside its plain version, SDPA or the bf16 matmul
    on the dequantized weight, and the bound."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_fwd_plain)
    from paddle_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul, quant_matmul_plain)
    from paddle_tpu_torch.quant import dequantize_weight
    b, T, h, kv, d = FT_PROMPT[0], FT_PROMPT[1] + FT_NEW, 32, 8, 128
    call_bytes = 2 * (2 * b * h * d + 2 * b * T * kv * d)
    n = copies_for(call_bytes)
    sets = [tuple(torch.randn(shape, generator=gen, device=dev)
                  .to(torch.bfloat16)
                  for shape in ((b, h, d), (b, T, kv, d), (b, T, kv, d)))
            for _ in range(n)]
    lib = [(q[:, :, None], *[c.transpose(1, 2).repeat_interleave(h // kv, 1)
                             .contiguous() for c in (ck, cv)])
           for q, ck, cv in sets]
    ci = torch.tensor(T - 1, dtype=torch.int32, device=dev)
    row = dict(ms=graph_ms(lambda i: decode_attention_fwd(*sets[i % n], ci),
                           calls=60),
               plain_ms=graph_ms(lambda i: decode_attention_fwd_plain(
                   *sets[i % n], T - 1), calls=10),
               library_ms=graph_ms(lambda i: TF.scaled_dot_product_attention(
                   *lib[i % n]), calls=60))
    row["bound_ms"], row["bound_by"] = bound(call_bytes, 4 * d * T * h * b)
    line = [f"decode q {[b, h, d]} cache {[b, T, kv, d]}: kernel "
            f"{row['ms']:.4f}, plain {row['plain_ms']:.4f}, sdpa "
            f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})"]
    del sets, lib
    m = b
    for din, dout in QUANT_SHAPES:
        code_bytes = din * dout
        n = copies_for(code_bytes)
        qs = [_quantized(gen, dev, din, dout, 8) for _ in range(n)]
        x = torch.randn(m, din, generator=gen, device=dev).to(torch.bfloat16)
        ms = graph_ms(lambda i: quant_matmul(x, *qs[i % n], 8), calls=60)
        bnd, by = bound(code_bytes + 2 * (din // 128) * dout
                        + 2 * m * (din + dout), 2 * m * din * dout)
        extra = ""
        if (din, dout) == (4096, 14336):
            ws = [dequantize_weight(q, sc, 8, dtype=torch.bfloat16)
                  for q, sc in qs]
            plain = graph_ms(lambda i: quant_matmul_plain(x, *qs[i % n], 8),
                             calls=6)
            libm = graph_ms(lambda i: torch.matmul(x, ws[i % n]), calls=60)
            extra = f", plain {plain:.4f}, bf16 matmul {libm:.4f}"
            del ws
        line.append(f"quant int8 {din}->{dout} m={m}: kernel {ms:.4f}"
                    f"{extra}, bound {bnd:.4f} ms ({by})")
        del qs
    log("[finetune] rows 4 and 7 at this phase's generate() shapes (CUDA "
        "graph device time): " + "; ".join(line) + f" [{card}]")
    gc.collect()
    torch.cuda.empty_cache()


def phase_finetune(seed, gen, dev, card):
    """Phase 18 (module docstring). Returns (launches of the main-path
    runs by kernel key, errors of the segment kernels)."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.peft import LoRAConfig, apply_lora, lora_state_dict
    t_phase = time.perf_counter()
    cfg = ptt.llama3_8b()
    rs = np.random.RandomState(seed + 90)
    examples, batch = _ft_examples(rs, cfg.vocab_size, FT_ROWS, FT_LEN)
    errs = _ft_segment_kernels(gen, dev, card, batch["segment_ids"])
    t0 = time.perf_counter()
    model = ptt.LlamaForCausalLM(cfg, device=dev,
                                 generator=ptt.make_generator(seed, dev))
    hit = apply_lora(model, LoRAConfig(**FT_LORA),
                     ptt.make_generator(seed + 91, dev))
    torch.cuda.synchronize()
    base = {k: v.detach().cpu() for k, v in model.named_parameters()
            if "lora" not in k}
    log(f"[finetune] Llama-3-8B (32 layers, {cfg.dtype}) from the seed with "
        f"LoRA r {FT_LORA['r']} alpha {FT_LORA['lora_alpha']} on {len(hit)} "
        f"projections, {len(examples)} prompt/response pairs of "
        f"{FT_EXAMPLE[0]}-{FT_EXAMPLE[1]} tokens packed into "
        f"[{FT_ROWS}, {FT_LEN}]; built and the base weights copied to the "
        f"host in {time.perf_counter() - t0:.1f} s")
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    sft, tr, step_ms = _ft_sft(model, batch, dev, card)
    add(sft)
    same = sum(torch.equal(p.detach().cpu(), base[k])
               for k, p in model.named_parameters() if k in base)
    moved = sum(bool(v.detach().abs().sum() > 0)
                for k, v in lora_state_dict(model).items()
                if k.endswith("lora_B"))
    log(f"[finetune] (a) base weights bit for bit as before training: "
        f"{same} of {len(base)}; lora_B moved: {moved} of {len(hit)}")
    if same != len(base) or moved != len(hit):
        fail("finetune: LoRA training changed a base weight or left an "
             "adapter's B unmoved")
    profile_train_step(tr, step_ms, card,
                       label=f"LoRA SFT step (32 layers, [{FT_ROWS}, "
                             f"{FT_LEN}] packed)", before_ms=None)
    # the update over the adapters alone (448 small tensors: an eager call
    # is host-bound; the profiled step above gives its device time)
    _adam_times([p.detach() for p in lora_state_dict(model).values()], dev,
                card, f"the adapters of 32 layers x 7 projections (r "
                      f"{FT_LORA['r']})", seed=51)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    _ft_packed_vs_lone(model, batch, dev)
    _ft_grads(seed, batch, dev)
    add(_ft_dpo(seed, model, dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    got, pred, stream = _ft_merge(seed, model, base, dev, card)
    add(got)
    del base
    add(_ft_ptq(seed, model, pred, stream, dev, card))
    del pred, model, stream
    gc.collect()
    torch.cuda.empty_cache()
    add(_ft_qat(seed, dev, card))
    _ft_decode_quant_times(gen, dev, card)
    log(f"[finetune] phase took {time.perf_counter() - t_phase:.1f} s; "
        f"launches of its main-path runs {launches} [{card}]")
    return launches, errs


ZOO_FLASH = (("GPT-1.3B", (4, 1024, 16, 128), True),
             ("GPT-2", (4, 1024, 12, 64), True),
             ("encoder", (8, 256, 8, 64), False))    # b, s, h, d; causal
# GPT-1.3B's four biased projections, whole (no tp): (label, din, dout,
# scale blocks, rank) as _tp_quant reads them
ZOO_QUANT = (("qkv", 2048, 6144, 16, 0), ("out", 2048, 2048, 16, 0),
             ("fc_in", 2048, 8192, 16, 0), ("fc_out", 8192, 2048, 64, 0))
ZOO_PROMPT = (4, 512)
ZOO_NEW = 128
ZOO_BEAM = (2, 2, 16)                # rows, beams, new tokens
ZOO_TRAIN = (4, 1024)
ZOO_STEPS = 3
ZOO_GPT2 = dict(vocab_size=50257, n_embd=768, n_layer=12, n_head=12,
                n_positions=1024, layer_norm_epsilon=1e-5)
ZOO_CLS = (32, 128)                  # ERNIE classifier batch; 1/4 padding
ZOO_ENC = dict(d_model=512, nhead=8, dim_feedforward=2048, layers=6)
ZOO_ENC_BATCH = (8, 256)
# the encoder's bf16 output and gradients on the kernels against the fp32
# module, over the same on the kernels' plain versions: both round to
# bf16, at other points (1.00-1.04 seen at 2 layers)
TOL_ZOO_RATIO = 1.25
GPT_PER_LAYER = 4                    # GPT's quantized projections a layer


def _zoo_flash(gen, dev, card, shapes=ZOO_FLASH, tag="[zoo] (a)"):
    """(a) The flash forward, dq and dk/dv at the slice's new shapes
    (``shapes``, default ``ZOO_FLASH``: GPT-1.3B's and GPT-2's causal
    prefill and training shapes, the encoder's non-causal one; ``tag``
    heads the lines), bf16: each against its plain
    version (``TOL_BF16``; the backward within ``TOL_BWD_BF16`` of the
    largest reference gradient) on the wgmma route by count, then its
    time beside the plain version, SDPA (forward; its backward asked for
    dq alone and for dk, dv alone) and the bound. Returns the rows."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels.flash_attention import (
        _delta, flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
        flash_attention_bwd_dq, flash_attention_bwd_dq_plain,
        flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    rows = []
    for label, (b, s, h, d), causal in shapes:
        fns = {"flash": flash_attention_fwd,
               "flash_bwd_dq": flash_attention_bwd_dq,
               "flash_bwd_dkv": flash_attention_bwd_dkv}
        kw = dict(causal=causal, scale=d ** -0.5, window=None)
        el = 2
        x_bytes = el * b * s * h * d
        row_bytes = 4 * b * h * s
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        prod = 2 * d * pairs
        n = copies_for(8 * x_bytes + row_bytes)
        sets, lib = [], []
        for _ in range(n):
            q, k, v, g, _ = _bwd_inputs(gen, dev, torch.bfloat16, b, s, h,
                                        h, d)
            out, lse = flash_attention_fwd(q, k, v, causal=causal)
            sets.append((q, k, v, g, lse, _delta(out, g), None, out))
            xs = [t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v)]
            lib.append((TF.scaled_dot_product_attention(
                *xs, is_causal=causal), xs, g.transpose(1, 2).contiguous()))
        before = {k: dict(f.launches_by_route) for k, f in fns.items()}
        q, k, v, g, _, _, _, _ = sets[0]
        out, lse = flash_attention_fwd(q, k, v, causal=causal)
        delta = _delta(out, g)
        ref_out, _ = flash_attention_fwd_plain(q, k, v, causal=causal)
        errs = {"flash": max_err(out, ref_out)}
        got = [flash_attention_bwd_dq(q, k, v, g, lse, delta, None, **kw),
               *flash_attention_bwd_dkv(q, k, v, g, lse, delta, None, **kw)]
        ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
        bad = []
        for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
            err, rmax = max_err(a, r), float(r.float().abs().max())
            key = "flash_bwd_dq" if gname == "dq" else "flash_bwd_dkv"
            errs[key] = max(errs.get(key, 0.0), err)
            if not err <= TOL_BWD_BF16 * rmax:
                bad.append(f"{gname} {err:.3e} > {TOL_BWD_BF16} x {rmax:.3e}")
        torch.cuda.synchronize()
        routes = {k: {r: c - before[k][r]
                      for r, c in f.launches_by_route.items()}
                  for k, f in fns.items()}
        log(f"{tag} flash at {label}'s shape q = k = v {[b, s, h, d]} "
            f"bf16 {'causal' if causal else 'non-causal'}: max_abs_err "
            f"against the plain versions " + ", ".join(
                f"{k} {e:.3e}" for k, e in errs.items())
            + f" (tol {TOL_BF16}, backward {TOL_BWD_BF16} x max|ref|); "
            f"launches by route {routes}")
        if errs["flash"] > TOL_BF16 or bad:
            fail(f"{tag} {label}: a flash kernel disagrees with its "
                 f"plain version ({bad})")
        if any(r["wgmma"] != 1 or r["simt"] for r in routes.values()):
            fail(f"{tag} {label}: not one wgmma launch each: {routes}")
        del got, ref, ref_out

        def fwd_args(i):
            return sets[i % n][:3]

        def bwd_args(i):
            return sets[i % n][:7]

        t = {}
        for key, fn, plain, lib_which, nbytes, flops in (
                ("flash", lambda i: flash_attention_fwd(*fwd_args(i),
                                                        causal=causal),
                 lambda i: flash_attention_fwd_plain(*fwd_args(i),
                                                     causal=causal),
                 None, 4 * x_bytes + row_bytes, 2 * prod),
                ("flash_bwd_dq", lambda i: flash_attention_bwd_dq(
                    *bwd_args(i), **kw),
                 lambda i: flash_attention_bwd_dq_plain(
                     *sets[i % n][:3], sets[i % n][7], sets[i % n][4],
                     sets[i % n][3], causal=causal),
                 [0], 5 * x_bytes + 2 * row_bytes, 3 * prod),
                ("flash_bwd_dkv", lambda i: flash_attention_bwd_dkv(
                    *bwd_args(i), **kw),
                 lambda i: flash_attention_bwd_dkv_plain(
                     *sets[i % n][:3], sets[i % n][7], sets[i % n][4],
                     sets[i % n][3], causal=causal),
                 [1, 2], 6 * x_bytes + 2 * row_bytes, 4 * prod)):
            if lib_which is None:
                lib_ms = cuda_ms(lambda i: TF.scaled_dot_product_attention(
                    *[x.detach() for x in lib[i % n][1]], is_causal=causal),
                    iters=10)
            else:
                lib_ms = cuda_ms(lambda i, w=lib_which: torch.autograd.grad(
                    lib[i % n][0], [lib[i % n][1][j] for j in w],
                    lib[i % n][2], retain_graph=True), iters=10)
            b_ms, b_by = bound(nbytes, flops)
            t[key] = dict(ms=cuda_ms(fn, iters=10),
                          plain_ms=cuda_ms(plain, iters=3, warmup=1),
                          library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                          err=errs[key])
            r = t[key]
            log(f"{tag} time {key} at {label}'s q {[b, s, h, d]} "
                f"{'causal' if causal else 'non-causal'}: kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
                f"{r['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}) "
                f"[{card}]")
            rows.append((label, key, r))
        del sets, lib
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def _zoo_generate(ptt, pred, ids, new, label, card, quant=0,
                  tag="[zoo]"):
    """``Predictor.generate`` on GPT, greedy, through its captured step:
    the counts set to 0 just before the timed run and read just after
    (no attention kernel: GPT attends its cache densely, as the JAX
    module does; quant ``quant`` a step when quantized, the 2048-row
    prefill taking the dequant route); the step graph's nodes hold no
    flash or decode kernel and ``quant`` quant nodes on mma; a second
    call and the uncaptured step give the same tokens. Returns (tokens,
    decode ms a step, launches)."""
    from paddle_tpu_torch.generation import eager_steps
    b, prompt = ids.shape
    greedy = ptt.GenerationConfig(max_new_tokens=new)
    one = ptt.GenerationConfig(max_new_tokens=1)
    pred.generate(ids, config=greedy)       # warm-up: captures the step
    pred.generate(ids, config=one)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.generate(ids, config=one)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    read = _reset_launches()
    t0 = time.perf_counter()
    out = pred.generate(ids, config=greedy)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = read()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = dict(NO_LAUNCHES, quant=quant * (new - 1))
    log(f"{tag} {label} launches in one generate: {launches} (want {want})")
    if launches != want:
        fail(f"{tag} {label}: kernel launches {launches} != {want}")
    if quant:
        _check_routes(f"{tag} {label}", quant=quant * (new - 1))
    prog = _step_program(pred.model, lambda k: k[:4] == (
        "generate", b, prompt + new, False), label)
    nodes, n_nodes, n_memory = _graph_kernels(
        prog, label, {"flash_fwd": 0, "decode_": 0, "qmm_mma": quant})
    decode_ms = (total_ms - prefill_ms) / (new - 1)
    log(f"{tag} {label} the decode step is one CUDA-graph replay of "
        f"{n_nodes} kernel nodes ({nodes}: no attention kernel) and "
        f"{n_memory} memcpy/memset nodes; prefill {prefill_ms:.1f} ms ({b} "
        f"x {prompt}), decode {decode_ms:.2f} ms/step, "
        f"{b * new / (total_ms / 1e3):.1f} new tokens/s, peak memory "
        f"{peak_gb:.2f} GB [{card}]")
    if not torch.equal(pred.generate(ids, config=greedy), out):
        fail(f"{tag} {label}: a second greedy generate gave other tokens")
    t0 = time.perf_counter()
    with eager_steps():
        eager = pred.generate(ids, config=greedy)
    torch.cuda.synchronize()
    eager_ms = ((time.perf_counter() - t0) * 1e3 - prefill_ms) / (new - 1)
    if not torch.equal(eager, out):
        fail(f"{tag} {label}: the graphed stream differs from the "
             f"uncaptured step's")
    log(f"{tag} {label} greedy streams bit for bit the uncaptured step's "
        f"({eager_ms:.2f} ms/step uncaptured) [{card}]")
    return out, decode_ms, launches


def _zoo_gpt(seed, dev, card):
    """(b) GPT-1.3B (``GPTConfig()``: 24 layers of 2048, 16 heads of 128,
    vocab 50304) in bf16 from the seed through ``Predictor.generate`` on
    [4, 512] prompts, 128 new tokens, and a short beam run; (c) the same
    weights rebuilt and quantized by the ``Predictor`` to int8 and to
    int4: 96 quant nodes a step graph on mma, each stream re-scored by
    its own model within ``TOL_TEACHER`` (and its gap under the bf16
    model printed). Returns the launches."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.quant import QuantizedLinear
    cfg = ptt.GPTConfig()
    L = cfg.num_hidden_layers

    def build():
        return ptt.GPTForCausalLM(cfg, device=dev,
                                  generator=ptt.make_generator(seed, dev))

    t0 = time.perf_counter()
    model = build()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[zoo] (b) GPT-1.3B (hidden {cfg.hidden_size}, {L} layers, "
        f"{cfg.num_attention_heads} heads of {cfg.head_dim}, ffn "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"tied head): {n_params / 1e9:.3f} B params, "
        f"{_weight_gb(model):.2f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    pred = ptt.Predictor(model, device=dev)
    ids = torch.randint(0, cfg.vocab_size, ZOO_PROMPT, device=dev,
                        generator=ptt.make_generator(seed + 1, dev))
    bf16, bf16_ms, _ = _zoo_generate(ptt, pred, ids, ZOO_NEW, "(b) bf16",
                                     card)
    gap = max(_teacher_gap(model, ids[r].tolist(),
                           bf16[r, ZOO_PROMPT[1]:].tolist())
              for r in range(ZOO_PROMPT[0]))
    if not gap <= TOL_TEACHER:
        fail(f"[zoo] (b): the bf16 stream re-scored by the model is "
             f"{gap:.4f} off its maxima")
    rows, beams, new = ZOO_BEAM
    beam_cfg = ptt.GenerationConfig(max_new_tokens=new, num_beams=beams)
    pred.generate(ids[:rows], config=beam_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    beam = pred.generate(ids[:rows], config=beam_cfg)
    torch.cuda.synchronize()
    beam_ms = (time.perf_counter() - t0) * 1e3
    if tuple(beam.shape) != (rows, ZOO_PROMPT[1] + new) or not bool(
            ((beam >= 0) & (beam < cfg.vocab_size)).all()):
        fail("[zoo] (b) beam search returned invalid ids")
    log(f"[zoo] (b) bf16 teacher-forced gap of the greedy streams "
        f"{gap:.4f} (tol {TOL_TEACHER}); beam search {rows} x {beams} beams"
        f", {new} new: {beam_ms:.1f} ms [{card}]")
    launches = {}
    for bits in (8, 4):
        qmodel = build()
        qpred = ptt.Predictor(qmodel,
                              ptt.Config().enable_weight_only_quant(bits),
                              device=dev)
        n_q = sum(isinstance(m, QuantizedLinear) for m in qmodel.modules())
        if n_q != GPT_PER_LAYER * L:
            fail(f"[zoo] (c) int{bits}: {n_q} projections quantized, want "
                 f"{GPT_PER_LAYER * L}")
        out, ms, got = _zoo_generate(ptt, qpred, ids, ZOO_NEW,
                                     f"(c) int{bits}", card,
                                     quant=GPT_PER_LAYER * L)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        own = max(_teacher_gap(qmodel, ids[r].tolist(),
                               out[r, ZOO_PROMPT[1]:].tolist())
                  for r in range(ZOO_PROMPT[0]))
        vs_bf16 = max(_teacher_gap(model, ids[r].tolist(),
                                   out[r, ZOO_PROMPT[1]:].tolist())
                      for r in range(ZOO_PROMPT[0]))
        same = int((out[:, ZOO_PROMPT[1]:] == bf16[:, ZOO_PROMPT[1]:]).sum())
        log(f"[zoo] (c) int{bits}: {n_q} projections on the quant kernel, "
            f"weights {_weight_gb(qmodel):.2f} GB; decode {ms:.2f} ms/step "
            f"against bf16's {bf16_ms:.2f}; its streams re-scored by its "
            f"own model {own:.4f} (tol {TOL_TEACHER}), by the bf16 model "
            f"{vs_bf16:.4f}; new tokens equal to bf16's {same} of "
            f"{ZOO_PROMPT[0] * ZOO_NEW} [{card}]")
        if not own <= TOL_TEACHER:
            fail(f"[zoo] (c) int{bits}: its stream re-scored by its own "
                 f"model is {own:.4f} off its maxima")
        del qpred, qmodel
        gc.collect()
        torch.cuda.empty_cache()
    return model, pred, launches


def _zoo_train_run(tr, steps, label, want, card, tokens=None,
                   flops_per_token=None, need_fall=True, unit="tokens",
                   tag="[zoo]"):
    """``tr.train()`` for ``steps`` steps with the counts set to 0 just
    before and read just after (they must equal ``want``, the routed
    kernels on their tensor-core routes); the losses finite (and falling,
    with ``need_fall``); step ms, tokens/s and MFU printed. Returns (the
    launches, the median step ms)."""
    import numpy as np

    import paddle_tpu_torch as ptt

    class StepClock(ptt.TrainerCallback):
        def __init__(self):
            self.t = []

        def on_step_end(self, step, logs):
            self.t.append(time.perf_counter())

    clock = StepClock()
    tr.callbacks.append(clock)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = _reset_launches()
    clock.t = [time.perf_counter()]
    tr.train()
    torch.cuda.synchronize()
    launches = read()
    tr.callbacks.remove(clock)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [v for _, v in tr.logger.history["loss"]][-steps:]
    log(f"{tag} {label} launches in {steps} steps: {launches} (want "
        f"{want}); losses " + ", ".join(f"{x:.4f}" for x in losses))
    if launches != want:
        fail(f"{tag} {label}: launches {launches} != {want}")
    _check_routes(f"zoo {label}", **{k: want[k] for k in (
        "flash", "flash_bwd_dq", "flash_bwd_dkv") if want[k]})
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"{tag} {label}: a loss is not finite")
    if need_fall and not losses[-1] < losses[0]:
        fail(f"{tag} {label}: the loss did not fall ({losses})")
    steps_ms = np.diff(clock.t) * 1e3
    step_ms = float(np.median(steps_ms[1:] if steps > 1 else steps_ms))
    line = (f"{tag} {label} step ms " + ", ".join(f"{x:.1f}"
                                                  for x in steps_ms)
            + f" (median of steps 2-{steps} {step_ms:.1f}), peak memory "
            f"{peak_gb:.2f} GB")
    if tokens:
        tps = tokens / (step_ms / 1e3)
        line += f", {tps:.0f} {unit}/s"
        if flops_per_token:
            line += (f", MFU {100 * flops_per_token * tps / BF16_FLOP_PER_S:.2f}"
                     f" % of {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s")
    log(line + f" [{card}]")
    return launches, step_ms


def _zoo_trainer(ptt, model, batches, steps, lr, loss_fn=None):
    """The Trainer at the JAX package's defaults: AdamW with fp32 masters
    and global-norm clipping at 1.0, logging every step."""
    opt = ptt.optimizer.AdamW(learning_rate=lr, multi_precision=True,
                              grad_clip=ptt.optimizer.ClipGradByGlobalNorm(
                                  1.0))
    args = ptt.TrainingArguments(output_dir="output/chip_smoke_zoo",
                                 max_steps=steps, logging_steps=1)
    return ptt.Trainer(model, opt, args, train_dataloader=batches,
                       loss_fn=loss_fn)


def _update_launches(model, steps):
    """The fused update's launches in ``steps`` steps: one a step for each
    dtype of the trainable parameters (one launch a (parameter,
    gradient) type group)."""
    return steps * len({p.dtype for p in model.parameters()
                        if p.requires_grad})


def _zoo_gpt_train(seed, dev, card):
    """(d) GPT-1.3B at its 24 layers, bf16, fresh from the seed, 3 Trainer
    steps (AdamW, fp32 masters) on one repeated [4, 1024] batch: flash,
    dq and dk/dv 24 a step on wgmma, one fused update a step; the loss
    falls; step ms, tokens/s, MFU (6N with the tied head + attention) and
    a profiled step."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.utils.profiler import llama_flops_per_token
    cfg = ptt.GPTConfig()
    model = ptt.GPTForCausalLM(cfg, device=dev,
                               generator=ptt.make_generator(seed + 2, dev))
    L = cfg.num_hidden_layers
    rs = np.random.RandomState(seed + 3)
    batch = rs.randint(0, cfg.vocab_size, ZOO_TRAIN)
    tr = _zoo_trainer(ptt, model, [batch], ZOO_STEPS, 1e-3)
    n = sum(p.numel() for p in model.parameters()) \
        - cfg.max_position_embeddings * cfg.hidden_size
    fpt = llama_flops_per_token(n, L, ZOO_TRAIN[1], cfg.hidden_size)
    want = dict(NO_LAUNCHES, flash=L * ZOO_STEPS,
                flash_bwd_dq=L * ZOO_STEPS, flash_bwd_dkv=L * ZOO_STEPS,
                fused_adamw=_update_launches(model, ZOO_STEPS))
    launches, step_ms = _zoo_train_run(
        tr, ZOO_STEPS, f"(d) GPT-1.3B train [{ZOO_TRAIN[0]}, {ZOO_TRAIN[1]}]",
        want, card, tokens=ZOO_TRAIN[0] * ZOO_TRAIN[1], flops_per_token=fpt)
    profile_train_step(tr, step_ms, card, label="GPT-1.3B train step "
                       f"([{ZOO_TRAIN[0]}, {ZOO_TRAIN[1]}], 24 layers)",
                       before_ms=None)
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _zoo_gpt2(seed, dev, card):
    """(e) GPT-2's widths (``ZOO_GPT2``: 768 wide, 12 heads of 64, vocab
    50257) written by hand from seeded bf16 weights as an HF checkpoint
    (GPT-2's names, ``Conv1D`` weights [in, out], no ``safetensors``
    package), through ``config_from_hf`` and ``from_pretrained``: the
    loaded weights bit for bit the written ones (through
    ``to``-the-JAX-layout ``jax_state_dict``), ``generate()`` on [4, 256]
    + 32 through the captured step, and one Trainer step at [4, 1024]
    with flash at d 64 (12 forward, dq and dk/dv on wgmma)."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import jax_state_dict
    from paddle_tpu_torch.models import hf_interop
    c = ZOO_GPT2
    h, V, P, L = c["n_embd"], c["vocab_size"], c["n_positions"], c["n_layer"]
    g = torch.Generator().manual_seed(seed + 4)

    def w(*shape, std=0.02):
        return (torch.randn(*shape, generator=g) * std).to(torch.bfloat16)

    tensors = {"transformer.wte.weight": w(V, h),
               "transformer.wpe.weight": w(P, h, std=0.01),
               "transformer.ln_f.weight": 1 + w(h, std=0.1),
               "transformer.ln_f.bias": w(h)}
    for i in range(L):
        p = f"transformer.h.{i}."
        for name, din, dout in (("attn.c_attn", h, 3 * h),
                                ("attn.c_proj", h, h),
                                ("mlp.c_fc", h, 4 * h),
                                ("mlp.c_proj", 4 * h, h)):
            tensors[p + name + ".weight"] = w(din, dout)
            tensors[p + name + ".bias"] = w(dout)
        for ln in ("ln_1", "ln_2"):
            tensors[p + ln + ".weight"] = 1 + w(h, std=0.1)
            tensors[p + ln + ".bias"] = w(h)
    d = tempfile.mkdtemp(prefix="zoo_gpt2_")
    try:
        _write_safetensors(os.path.join(d, "model.safetensors"), tensors)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(c, model_type="gpt2", torch_dtype="bfloat16"), f)
        cls, cfg, mt = hf_interop.config_from_hf(d)
        t0 = time.perf_counter()
        model = hf_interop.from_pretrained(d, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    got = jax_state_dict(model)
    want = {"model.embed_tokens.weight": tensors["transformer.wte.weight"],
            "model.embed_positions": tensors["transformer.wpe.weight"],
            "model.layers.5.attn.qkv_proj.weight":
                tensors["transformer.h.5.attn.c_attn.weight"],
            "model.layers.11.mlp.fc_out.bias":
                tensors["transformer.h.11.mlp.c_proj.bias"]}
    if cls.__name__ != "GPTForCausalLM" or (cfg.hidden_size, cfg.head_dim,
                                            cfg.vocab_size) != (h, 64, V):
        fail(f"[zoo] (e) config_from_hf gave {cls.__name__} {cfg}")
    if not all(torch.equal(got[k], v) for k, v in want.items()):
        fail("[zoo] (e) a loaded GPT-2 tensor differs from the written one")
    pred = ptt.Predictor(model, device=dev)
    ids = torch.randint(0, V, (4, 256), device=dev,
                        generator=ptt.make_generator(seed + 5, dev))
    _zoo_generate(ptt, pred, ids, 32, "(e) GPT-2", card)
    rs = np.random.RandomState(seed + 6)
    tr = _zoo_trainer(ptt, model, [rs.randint(0, V, ZOO_TRAIN)], 1, 1e-4)
    want = dict(NO_LAUNCHES, flash=L, flash_bwd_dq=L, flash_bwd_dkv=L,
                fused_adamw=_update_launches(model, 1))
    launches, _ = _zoo_train_run(tr, 1, "(e) GPT-2 train step", want, card,
                                 tokens=ZOO_TRAIN[0] * ZOO_TRAIN[1],
                                 need_fall=False)
    log(f"[zoo] (e) GPT-2 widths from a hand-written HF checkpoint "
        f"({sum(t.numel() for t in tensors.values()) / 1e6:.1f} M params, "
        f"bf16): config_from_hf -> {cls.__name__}, from_pretrained "
        f"{load_s:.2f} s, the sampled tensors bit for bit [{card}]")
    del tr, model, pred
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _zoo_encoders(seed, dev, card):
    """(f) ``ErnieForSequenceClassification`` at ``ErnieConfig()`` (ERNIE
    3.0 base widths) in bf16: 3 Trainer steps at [32, 128], a quarter of
    the positions padding, dropout 0.1 drawn from the model's generator
    (dense attention under the padding bias, as in JAX; the fused update
    once a step for each parameter dtype); ``ErnieForMaskedLM`` logits
    (finite, fp32, [32, 128, 40000]); one ``BertForPretraining`` step at
    ``BertConfig()`` with the MLM + NSP loss."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import pretraining_loss
    from paddle_tpu_torch.nn import functional as F
    b, s = ZOO_CLS
    rs = np.random.RandomState(seed + 7)
    mask = np.ones((b, s), np.int64)
    for r in range(b):
        mask[r, s - int(rs.randint(0, s // 2)):] = 0    # a quarter, mean
    ecfg = ptt.ErnieConfig()
    ids = rs.randint(0, ecfg.vocab_size, (b, s))
    batch = {k: torch.from_numpy(v) for k, v in (
        ("ids", ids), ("mask", mask), ("types", np.zeros_like(ids)),
        ("labels", rs.randint(0, 2, b)))}
    model = ptt.ErnieForSequenceClassification(
        ecfg, device=dev, generator=ptt.make_generator(seed + 8, dev))

    def cls_loss(m, bt):
        return F.cross_entropy(m(bt["ids"], bt["types"], bt["mask"]),
                               bt["labels"])

    tr = _zoo_trainer(ptt, model, [batch], ZOO_STEPS, 1e-4, cls_loss)
    want = dict(NO_LAUNCHES, fused_adamw=_update_launches(model, ZOO_STEPS))
    launches, _ = _zoo_train_run(
        tr, ZOO_STEPS, f"(f) ERNIE 3.0 base classifier [{b}, {s}], "
        f"{1 - mask.mean():.3f} padding, dropout "
        f"{ecfg.hidden_dropout_prob}", want, card,
        tokens=int(mask.sum()), need_fall=False)
    del tr, model
    mlm = ptt.ErnieForMaskedLM(ecfg, device=dev,
                               generator=ptt.make_generator(seed + 9, dev))
    mlm.eval()
    tb = {k: v.to(dev) for k, v in batch.items()}
    with torch.inference_mode():
        logits = mlm(tb["ids"], tb["types"], tb["mask"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = mlm(tb["ids"], tb["types"], tb["mask"])
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    if tuple(logits.shape) != (b, s, ecfg.vocab_size) or \
            logits.dtype != torch.float32 or \
            not bool(torch.isfinite(logits).all()):
        fail("[zoo] (f) ErnieForMaskedLM logits are not finite fp32 of "
             "the expected shape")
    log(f"[zoo] (f) ErnieForMaskedLM eval forward [{b}, {s}]: "
        f"{fwd_ms:.1f} ms, logits fp32 {list(logits.shape)} finite "
        f"[{card}]")
    del mlm, logits
    bcfg = ptt.BertConfig()
    bert = ptt.BertForPretraining(bcfg, device=dev,
                                  generator=ptt.make_generator(seed + 10,
                                                               dev))
    bids = rs.randint(0, bcfg.vocab_size, (b, s))
    mlm_labels = np.where(rs.rand(b, s) < 0.15, bids, -100)
    bb = {k: torch.from_numpy(v) for k, v in (
        ("ids", bids), ("mask", mask), ("types", np.zeros_like(bids)),
        ("mlm", mlm_labels), ("nsp", rs.randint(0, 2, b)))}

    def pt_loss(m, bt):
        mlm_logits, nsp_logits = m(bt["ids"], bt["types"], bt["mask"])
        return pretraining_loss(mlm_logits, bt["mlm"], nsp_logits,
                                bt["nsp"])

    tr = _zoo_trainer(ptt, bert, [bb], 1, 1e-4, pt_loss)
    want = dict(NO_LAUNCHES, fused_adamw=_update_launches(bert, 1))
    got, _ = _zoo_train_run(tr, 1, f"(f) BERT-base pretraining step [{b}, "
                            f"{s}] (MLM + NSP)", want, card,
                            need_fall=False)
    for k, v in got.items():
        launches[k] += v
    del tr, bert
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _zoo_encoder_stack(seed, dev, card):
    """(g) ``nn.TransformerEncoder`` (``ZOO_ENC``: 6 layers, 512 wide, 8
    heads, FFN 2048, post-norm, relu) in bf16 at [8, 256]: an eval
    forward on the flash kernel (6 launches on wgmma); the output and the
    input's and every parameter's gradient of a loss at dropout 0, on the
    kernels and on their plain versions, each against the same module in
    fp32 on the plain versions: the kernels' error within
    ``TOL_ZOO_RATIO`` times the plain versions' (the two round to bf16 at
    other points, ~3e-2 apart in relative l2 through two post-norm
    layers, each ~3e-2 from fp32); then one Trainer step (6 forward, dq
    and dk/dv on wgmma, one fused update)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    c = ZOO_ENC
    L = c["layers"]
    layer = nn.TransformerEncoderLayer(
        c["d_model"], c["nhead"], c["dim_feedforward"], dropout=0.0,
        device=dev, generator=ptt.make_generator(seed + 11, dev))
    enc32 = nn.TransformerEncoder(layer, L)
    enc = copy.deepcopy(enc32).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(seed + 12)
    x = torch.randn(*ZOO_ENC_BATCH, c["d_model"], generator=g,
                    device=dev).to(torch.bfloat16)
    target = torch.randn(x.shape, generator=g, device=dev)
    enc.eval()
    read = _reset_launches()
    with torch.no_grad():
        out = enc(x)
    torch.cuda.synchronize()
    launches = read()
    _check_routes("zoo (g) eval", flash=L)

    def run(module, inp, plain, train):
        """[output, the input's and every parameter's gradient of the
        loss], in fp32, of ``module`` on the kernels or, with ``plain``,
        on their plain versions."""
        module.train(train)
        inp = inp.detach().requires_grad_()
        params = [inp] + list(module.parameters())
        real = fa.flash_attention_fwd, fa.flash_attention_bwd
        if plain:
            fa.flash_attention_fwd = fa.flash_attention_fwd_plain
            fa.flash_attention_bwd = fa.flash_attention_bwd_plain
        try:
            y = module(inp)
            grads = torch.autograd.grad(
                (y.float() - target).square().mean(), params)
        finally:
            fa.flash_attention_fwd, fa.flash_attention_bwd = real
        return [y.detach().float()] + [t.float() for t in grads]

    names = ["output", "x"] + [n for n, _ in enc.named_parameters()]
    ref = run(enc32, x.float(), True, False)
    kern = run(enc, x, False, True)
    plain = run(enc, x, True, True)
    # each bf16 result against the fp32 plain module: the kernels must add
    # no error beyond the plain versions' own bf16 rounding (k_proj's bias
    # has a zero gradient up to rounding: both are noise against it)
    ratios = [(_rel_l2(a, r) / _rel_l2(p, r), n)
              for n, a, p, r in zip(names, kern, plain, ref)]
    worst = max(ratios)
    log(f"[zoo] (g) nn.TransformerEncoder ({L} layers, {c['d_model']} wide, "
        f"{c['nhead']} heads, ffn {c['dim_feedforward']}, bf16) at "
        f"{list(ZOO_ENC_BATCH)}: eval forward on the flash kernel "
        f"(launches {launches['flash']}); output and {len(names) - 1} "
        f"gradients in bf16 against the fp32 module: on the kernels "
        f"relative l2 {_rel_l2(kern[0], ref[0]):.3e} (output), "
        f"{_rel_l2(kern[1], ref[1]):.3e} (x), on the plain versions "
        f"{_rel_l2(plain[0], ref[0]):.3e}, {_rel_l2(plain[1], ref[1]):.3e};"
        f" worst kernels / plain ratio {worst[0]:.3f} ({worst[1]}; tol "
        f"{TOL_ZOO_RATIO}); kernels against plain output "
        f"{_rel_l2(out.float(), plain[0]):.3e} [{card}]")
    if not worst[0] <= TOL_ZOO_RATIO:
        fail("[zoo] (g) the encoder on the flash kernels is further from "
             "the fp32 module than on their plain versions")
    del ref, kern, plain, enc32
    enc.train()
    tr = _zoo_trainer(ptt, enc, [{"x": x, "y": target}], 1, 1e-4,
                      lambda m, bt: (m(bt["x"]).float() - bt["y"])
                      .square().mean())
    want = dict(NO_LAUNCHES, flash=L, flash_bwd_dq=L, flash_bwd_dkv=L,
                fused_adamw=_update_launches(enc, 1))
    got, _ = _zoo_train_run(tr, 1, "(g) encoder train step", want, card,
                            need_fall=False)
    for k, v in got.items():
        launches[k] += v
    del tr, enc
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_zoo(seed, gen, dev, card):
    """Phase 19 (module docstring). Returns (the launches of the
    main-path runs by kernel key, the (a) rows)."""
    rows = _zoo_flash(gen, dev, card)
    rows += [("GPT-1.3B", f"quant {label}", r)
             for label, r in _tp_quant(gen, dev, card, table=ZOO_QUANT,
                                       tag="[zoo] (a)")]
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    model, pred, got = _zoo_gpt(seed, dev, card)
    add(got)
    del model, pred
    gc.collect()
    torch.cuda.empty_cache()
    add(_zoo_gpt_train(seed, dev, card))
    add(_zoo_gpt2(seed, dev, card))
    add(_zoo_encoders(seed, dev, card))
    add(_zoo_encoder_stack(seed, dev, card))
    log(f"[zoo] launches of the phase's main-path runs {launches} [{card}]")
    return launches, rows


# ------------------------------------------------------------------ vision
VISION_DIT_LABELS = [207, 360, 387, 974]   # 4 classes: 8 rows with guidance
VISION_DIT_STEPS = 50                       # DDIM steps of (a)
VISION_SD3_STEPS = 28                       # SD3's default, (b)
VISION_SD3_TEXT = (1, 333)                  # 77 CLIP + 256 T5 tokens
VISION_BATCH = 64                           # (c), (d) images a step
VISION_OCR_DET = (4, 3, 640, 640)           # (e) DBNet
VISION_OCR_REC = (64, 3, 32, 128)           # (e) SVTR
VISION_STEPS = 3                            # Trainer steps a family
VISION_LR = 1e-4
# bf16 against fp32 on the same weights, relative l2 of the output: a
# whole model (its rounded activations over every layer), and one block
# alone (a rounding point out of place shows there first)
TOL_VISION_MODEL = 5e-2
TOL_VISION_BLOCK = 2e-2
# the weights' noise over their init (adaLN-Zero starts at zero)
VISION_NOISE = 0.02
CONV_KERNELS = ("conv", "implicit", "dgrad", "wgrad", "fprop", "xmma",
                "cudnn", "winograd")


@torch.no_grad()
def _noised(model, seed, std=VISION_NOISE):
    """Seeded noise on every trainable floating parameter, in place:
    adaLN-Zero's modulation and output projections start at zero, which
    would make a DiT block the identity and its output zero. (DiT's frozen
    sin-cos table stays as it is, as a checkpoint leaves it.)"""
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(seed)
    for p in model.parameters():
        if p.is_floating_point() and p.requires_grad:
            p.add_((std * torch.randn(p.shape, generator=gen,
                                      device=p.device)).to(p.dtype))
    return model


def _rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _fp32_twin(model, cls, cfg):
    """The same weights (the bf16 values, exactly) in an fp32 model."""
    import dataclasses

    import paddle_tpu_torch as ptt
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    for sub in ("text", "vision"):
        if hasattr(cfg32, sub):
            setattr(cfg32, sub, dataclasses.replace(getattr(cfg32, sub),
                                                    dtype=torch.float32))
    dev = next(model.parameters()).device
    twin = cls(cfg32, device=dev, generator=ptt.make_generator(0, dev))
    twin.load_state_dict(model.state_dict())
    return twin.eval()


def _timed(fn, reps=3):
    """(the last result, median ms of ``reps`` calls, host clock with a
    synchronize)."""
    out, ms = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, sorted(ms)[len(ms) // 2]


class _CountedGraph:
    """A captured graph whose replays are counted."""

    def __init__(self, graph):
        self.graph, self.n = graph, 0

    def replay(self):
        self.n += 1
        self.graph.replay()


def _denoise_run(pipe, args, steps, scale, label, card, seed):
    """The pipeline's denoising loop (no VAE): the first call captures
    the step; the second is timed with its replays counted (one a step);
    an eager run of the same steps (``eager_steps``) must equal it bit for
    bit. Returns (latents, ms a step, the step's FLOPs, kernel nodes)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.generation import eager_steps
    from torch.utils.flop_counter import FlopCounterMode

    def call():
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        with ptt.amp.auto_cast(dtype="bfloat16"):
            return pipe(*args, num_inference_steps=steps,
                        guidance_scale=scale, generator=gen)
    call()
    progs = list(pipe._programs.programs.values())
    if len(progs) != 1 or progs[0].step.graph is None:
        fail(f"[vision] {label}: the denoising step was not captured once "
             f"({len(progs)} programs)")
    prog = progs[0]
    tick = prog.step.graph
    counted = _CountedGraph(tick.graph)
    tick_graph = tick.graph
    prog.step.graph = tick._replace(graph=counted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latents = call()
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / steps
    prog.step.graph = tick._replace(graph=tick_graph)
    if counted.n != steps:
        fail(f"[vision] {label}: {counted.n} graph replays for {steps} "
             f"denoising steps")
    with eager_steps():
        eager = call()
    if not torch.equal(latents, eager):
        fail(f"[vision] {label}: the replayed loop's latents differ from "
             f"the eager loop's (max |d| {max_err(latents, eager):.3e})")
    if len(pipe._programs) != 1:
        fail(f"[vision] {label}: the eager run built another program")
    names, memory = graph_nodes(tick_graph)
    x = prog.x.clone()
    with torch.no_grad(), FlopCounterMode(display=False) as fc, \
            ptt.amp.auto_cast(dtype="bfloat16"):
        prog.guided(x, prog.ts[:1].expand(x.shape[0]), prog.scale,
                    *prog.cond)
    return latents, ms_step, fc.get_total_flops(), len(names) + memory


def _vision_pipeline(label, pipe, latent_pipe, args, steps, scale, card,
                     seed, bytes_weights):
    """(a) / (b): the loop timed and checked (``_denoise_run``), the VAE
    decode timed, the whole pipeline once (images, images/s, peak
    memory)."""
    import paddle_tpu_torch as ptt
    torch.cuda.reset_peak_memory_stats()
    latents, ms_step, flops, nodes = _denoise_run(
        latent_pipe, args, steps, scale, label, card, seed)
    vae = pipe.vae
    with torch.no_grad(), ptt.amp.auto_cast(dtype="bfloat16"):
        images, ms_decode = _timed(
            lambda: vae.decode(latents / vae.config.scaling_factor))

    def whole():
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        with ptt.amp.auto_cast(dtype="bfloat16"):
            return pipe(*args, num_inference_steps=steps,
                        guidance_scale=scale, generator=gen)
    whole()
    out, ms_whole = _timed(whole, reps=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not torch.isfinite(out.float()).all() or \
            not torch.equal(out, images):
        fail(f"[vision] {label}: the pipeline's images are not finite or "
             f"differ from the loop's latents decoded")
    n = out.shape[0]
    bound_ops = flops / BF16_FLOP_PER_S * 1e3
    bound_bytes = bytes_weights / HBM_BYTES_PER_S * 1e3
    log(f"[vision] {label}: {steps} steps, {ms_step:.2f} ms a denoising "
        f"step (one graph replay each, {nodes} nodes; bound "
        f"{max(bound_ops, bound_bytes):.3f} ms by "
        f"{'operations' if bound_ops >= bound_bytes else 'bytes'}: "
        f"{flops / 1e12:.2f} TFLOP at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s, "
        f"{bytes_weights / 1e9:.2f} GB of weights at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: "
        f"{100 * max(bound_ops, bound_bytes) / ms_step:.1f} %); the replayed "
        f"latents bit for bit the eager loop's; VAE decode {ms_decode:.1f} "
        f"ms; the pipeline {ms_whole:.1f} ms for {n} images "
        f"({n / ms_whole * 1e3:.2f} images/s); images "
        f"{list(out.shape)} finite; peak memory {peak:.2f} GB [{card}]")
    return latents


def _weight_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _vision_dit(seed, dev, card):
    """(a) DiT-XL/2 + the SD VAE through ``DiTPipeline``."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.diffusion import DiTPipeline
    from paddle_tpu_torch.models import dit, vae
    cfg = dit.dit_xl_2(dtype=torch.bfloat16)
    model = _noised(dit.DiT(cfg, device=dev,
                            generator=ptt.make_generator(seed + 300, dev)),
                    seed + 301)
    ae = _noised(vae.AutoencoderKL(vae.VAEConfig(dtype=torch.bfloat16),
                                   device=dev,
                                   generator=ptt.make_generator(seed + 302,
                                                                dev)),
                 seed + 303)
    n = sum(p.numel() for p in model.parameters())
    log(f"[vision] (a) DiT-XL/2 (dit_xl_2(): {cfg.num_hidden_layers} "
        f"layers, {cfg.hidden_size} wide, {cfg.num_attention_heads} heads, "
        f"{(cfg.input_size // cfg.patch_size) ** 2} tokens) {n / 1e6:.1f} M "
        f"params bf16; the SD VAE (VAEConfig()) "
        f"{sum(p.numel() for p in ae.parameters()) / 1e6:.1f} M; "
        f"{len(VISION_DIT_LABELS)} labels x 2 rows with guidance, DDIM")
    pipe = DiTPipeline(model, ae)
    latent_pipe = DiTPipeline(model)
    _vision_pipeline("(a) DiT-XL/2 256x256", pipe, latent_pipe,
                     (VISION_DIT_LABELS,), VISION_DIT_STEPS, 4.0, card,
                     seed + 304, _weight_bytes(model))
    return model, ae, pipe


def _vision_sd3(seed, dev, card):
    """(b) MMDiT at SD3-medium's widths + a 16-channel SD VAE through
    ``StableDiffusion3Pipeline``."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.diffusion import StableDiffusion3Pipeline
    from paddle_tpu_torch.models import dit, vae
    cfg = dit.MMDiTConfig(dtype=torch.bfloat16)
    model = _noised(dit.MMDiT(cfg, device=dev,
                              generator=ptt.make_generator(seed + 310, dev)),
                    seed + 311)
    ae = _noised(vae.AutoencoderKL(
        vae.VAEConfig(latent_channels=16, dtype=torch.bfloat16), device=dev,
        generator=ptt.make_generator(seed + 312, dev)), seed + 313)
    gen = torch.Generator(device=dev).manual_seed(seed + 314)
    ctx = torch.randn(VISION_SD3_TEXT + (cfg.context_dim,), generator=gen,
                      device=dev)
    pooled = torch.randn(VISION_SD3_TEXT[0], cfg.pooled_dim, generator=gen,
                         device=dev)
    n = sum(p.numel() for p in model.parameters())
    log(f"[vision] (b) MMDiT at MMDiTConfig() ({cfg.num_hidden_layers} "
        f"layers, {cfg.hidden_size} wide, {cfg.num_attention_heads} heads, "
        f"{(cfg.input_size // cfg.patch_size) ** 2} image + "
        f"{VISION_SD3_TEXT[1]} text tokens) {n / 1e9:.3f} B params bf16; "
        f"context {list(ctx.shape)}, pooled {list(pooled.shape)}; VAE "
        f"latent 16; flow matching, shift 3, guidance 7")
    pipe = StableDiffusion3Pipeline(model, ae)
    latent_pipe = StableDiffusion3Pipeline(model)
    _vision_pipeline("(b) MMDiT 512x512", pipe, latent_pipe, (ctx, pooled),
                     VISION_SD3_STEPS, 7.0, card, seed + 315,
                     _weight_bytes(model))
    return model, ae, (ctx, pooled)


def _vision_train(ptt, model, batch, loss_fn, label, card, images,
                  need_fall=True):
    tr = _zoo_trainer(ptt, model, [batch], VISION_STEPS, VISION_LR,
                      loss_fn=loss_fn)
    tr.args.output_dir = "output/chip_smoke_vision"
    want = dict(NO_LAUNCHES,
                fused_adamw=_update_launches(model, VISION_STEPS))
    launches, step_ms = _zoo_train_run(
        tr, VISION_STEPS, label, want, card, tokens=images, unit="images",
        need_fall=need_fall, tag="[vision]")
    return tr, launches, step_ms


def _eval_forward(model, fn, label, card, images):
    model.eval()
    with torch.no_grad():
        out, ms = _timed(fn)
    if not torch.isfinite(out.float()).all():
        fail(f"[vision] {label}: the eval forward is not finite")
    log(f"[vision] {label} eval forward {ms:.1f} ms ({images / ms * 1e3:.0f} "
        f"images/s), output {list(out.shape)} finite [{card}]")
    model.train()
    return out


def _conv_share(tr, card, label):
    """torch.profiler over one more Trainer step: the device time of the
    convolution kernels (cuDNN's) against the whole busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train(max_steps=tr.global_step + 1)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in ("train_step", "optimizer_apply")]
    if not kernels:
        log(f"[profile] {label}: no device events recorded: the conv share "
            f"is not measured")
        return None
    conv = sum(e.time_range.elapsed_us() for e in kernels
               if any(w in e.name.lower() for w in CONV_KERNELS)) / 1e3
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[profile] {label}: device busy {busy:.1f} ms in {len(kernels)} "
        f"ops, convolution kernels {conv:.1f} ms ({100 * conv / busy:.1f} "
        f"%); the largest kernels by name: "
        + "; ".join(f"{n[:70]} {ms:.1f} ms" for n, ms in top) + f" [{card}]")
    return conv / busy


def _vision_vit_clip(seed, dev, card):
    """(c) ViT-B/16: an eval forward at [64, 3, 224, 224] and 3 Trainer
    steps of its classifier; CLIP (ViT-B/16 + the 12-layer text tower): 3
    contrastive Trainer steps at batch 64, text length 77."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import clip, vit
    from paddle_tpu_torch.nn import functional as F
    rs = np.random.RandomState(seed + 320)
    launches = 0
    bf = torch.bfloat16
    model = vit.ViTForImageClassification(
        vit.vit_base_patch16_224(dtype=bf), device=dev,
        generator=ptt.make_generator(seed + 321, dev))
    size = model.config.image_size
    px = torch.from_numpy(rs.randn(VISION_BATCH, 3, size, size)
                          .astype(np.float32)).to(dev, bf)
    shape = f"[{VISION_BATCH}, 3, {size}, {size}]"
    _eval_forward(model, lambda: model(px), f"(c) ViT-B/16 {shape}",
                  card, VISION_BATCH)
    labels = torch.from_numpy(rs.randint(0, 1000, VISION_BATCH)).to(dev)
    _, n, _ = _vision_train(
        ptt, model, {"px": px, "labels": labels},
        lambda m, b: F.cross_entropy(m(b["px"]), b["labels"]),
        f"(c) ViT-B/16 classifier train {shape}", card, VISION_BATCH)
    launches += n["fused_adamw"]
    del model
    cfg = clip.CLIPConfig()
    cfg.text.dtype = cfg.vision.dtype = bf
    model = clip.CLIPModel(cfg, device=dev,
                           generator=ptt.make_generator(seed + 322, dev))
    text = cfg.text.max_position_embeddings
    ids = torch.from_numpy(rs.randint(1, cfg.text.vocab_size - 1,
                                      (VISION_BATCH, text))).to(dev)
    ids[:, -1] = cfg.text.vocab_size - 1           # end of text
    size = cfg.vision.image_size
    px = px[..., :size, :size]
    _, n, _ = _vision_train(
        ptt, model, {"ids": ids, "px": px},
        lambda m, b: clip.clip_contrastive_loss(*m(b["ids"], b["px"])),
        f"(c) CLIP ViT-B/16 contrastive train, batch {VISION_BATCH}, text "
        f"{text}", card, VISION_BATCH)
    launches += n["fused_adamw"]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _vision_resnet(seed, dev, card):
    """(d) ResNet-50: an eval forward at [64, 3, 224, 224], 3 Trainer steps
    (BatchNorm's running statistics untouched by them, moved by an eager
    train-mode forward, as on the CPU), the conv share of a profiled
    step."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.nn import functional as F
    rs = np.random.RandomState(seed + 330)
    bf = torch.bfloat16
    model = resnet.resnet50(device=dev, dtype=bf,
                            generator=ptt.make_generator(seed + 331, dev))
    px = torch.from_numpy(rs.randn(VISION_BATCH, 3, 224, 224)
                          .astype(np.float32)).to(dev, bf)
    _eval_forward(model, lambda: model(px), "(d) ResNet-50 [64, 3, 224, 224]",
                  card, VISION_BATCH)
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("._mean", "._variance"))}
    labels = torch.from_numpy(rs.randint(0, 1000, VISION_BATCH)).to(dev)
    tr, n, _ = _vision_train(
        ptt, model, {"px": px, "labels": labels},
        lambda m, b: F.cross_entropy(m(b["px"]), b["labels"]),
        "(d) ResNet-50 train [64, 3, 224, 224]", card, VISION_BATCH)
    moved = [k for k, v in stats.items()
             if not torch.equal(model.state_dict()[k], v)]
    if moved:
        fail(f"[vision] (d) Trainer steps moved BatchNorm's running "
             f"statistics ({moved[:3]}); the JAX Trainer leaves them")
    _conv_share(tr, card, "(d) ResNet-50 train step [64, 3, 224, 224]")
    model.train()
    with torch.no_grad():
        model(px)
    still = [k for k, v in stats.items()
             if torch.equal(model.state_dict()[k], v)]
    if still:
        fail(f"[vision] (d) an eager train-mode forward left running "
             f"statistics in place ({still[:3]})")
    log(f"[vision] (d) BatchNorm: {len(stats)} running-statistics buffers "
        f"untouched by {VISION_STEPS + 1} Trainer steps, all moved by one "
        f"eager train-mode forward (as the JAX package) [{card}]")
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()
    return n["fused_adamw"]


def _vision_ocr(seed, dev, card):
    """(e) DBNet (DBNetConfig(): a ResNet-18 backbone): a forward at [4, 3,
    640, 640] and 3 ``db_loss`` steps on seeded maps; SVTR
    (SVTRConfig()): 3 ``ctc_rec_loss`` steps at [64, 3, 32, 128], then
    ``ctc_greedy_decode``."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import ppocr
    rs = np.random.RandomState(seed + 340)
    bf = torch.bfloat16
    launches = 0
    model = ppocr.DBNet(ppocr.DBNetConfig(dtype=bf), device=dev,
                        generator=ptt.make_generator(seed + 341, dev))
    px = torch.from_numpy(rs.randn(*VISION_OCR_DET).astype(np.float32)) \
        .to(dev, bf)
    _eval_forward(model, lambda: model(px)["maps"],
                  f"(e) DBNet {list(VISION_OCR_DET)}", card,
                  VISION_OCR_DET[0])
    b, _, h, w = VISION_OCR_DET
    maps = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        shrink=(rs.rand(b, h, w) < 0.1), mask=(rs.rand(b, h, w) < 0.95),
        thresh=rs.uniform(0.3, 0.7, (b, h, w)),
        tmask=(rs.rand(b, h, w) < 0.4)).items()}
    maps = {k: v.float() for k, v in maps.items()}
    _, n, _ = _vision_train(
        ptt, model, {"px": px, **maps},
        lambda m, bt: ppocr.db_loss(m(bt["px"]), bt["shrink"], bt["mask"],
                                    bt["thresh"], bt["tmask"]),
        f"(e) DBNet db_loss train {list(VISION_OCR_DET)}", card, b)
    launches += n["fused_adamw"]
    del model
    cfg = ppocr.SVTRConfig(dtype=bf)
    model = ppocr.SVTRNet(cfg, device=dev,
                          generator=ptt.make_generator(seed + 342, dev))
    px = torch.from_numpy(rs.randn(*VISION_OCR_REC).astype(np.float32)) \
        .to(dev, bf)
    nb = VISION_OCR_REC[0]
    # labels of up to half the CTC frames (the width / 4), so that every
    # alignment exists
    longest = min(25, cfg.img_width // 8)
    labels = torch.from_numpy(rs.randint(1, cfg.num_classes,
                                         (nb, longest))).to(dev)
    lens = torch.from_numpy(rs.randint(longest // 2, longest + 1,
                                       nb)).to(dev)
    _, n, _ = _vision_train(
        ptt, model, {"px": px, "labels": labels, "lens": lens},
        lambda m, bt: ppocr.ctc_rec_loss(m(bt["px"]), bt["labels"],
                                         bt["lens"]),
        f"(e) SVTR ctc_rec_loss train {list(VISION_OCR_REC)}", card, nb)
    launches += n["fused_adamw"]
    model.eval()
    with torch.no_grad():
        ids, keep = ppocr.ctc_greedy_decode(model(px))
    log(f"[vision] (e) ctc_greedy_decode: ids {list(ids.shape)}, "
        f"{int(keep.sum())} of {keep.numel()} positions kept [{card}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _write_diffusers(d, config, arrays):
    """A diffusers checkpoint in ``d``: ``config.json`` and
    ``diffusion_pytorch_model.safetensors`` of {name: fp32 numpy} written
    as bf16, without the ``safetensors`` package. Returns the bytes."""
    import numpy as np
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)
    path = os.path.join(d, "diffusion_pytorch_model.safetensors")
    _write_safetensors(path, {k: torch.from_numpy(
        np.ascontiguousarray(v)).to(torch.bfloat16)
        for k, v in arrays.items()})
    return os.path.getsize(path)


def _vision_diffusers(dit_model, ae, dev, card, seed):
    """(f) DiT-XL/2 as a diffusers ``DiTTransformer2DModel`` checkpoint and
    the SD VAE as an ``AutoencoderKL``, written by hand (bf16) from (a)'s
    seeded weights through ``to_hf_state_dict``, loaded with
    ``config_from_hf`` / ``from_pretrained``: every parameter bit for bit
    the source's, and two pipeline steps on them bit for bit the source
    pipeline's."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.diffusion import DiTPipeline
    from paddle_tpu_torch.models import hf_interop
    cfg, vcfg = dit_model.config, ae.config
    configs = {
        "dit": dict(_class_name="DiTTransformer2DModel",
                    sample_size=cfg.input_size, patch_size=cfg.patch_size,
                    in_channels=cfg.in_channels,
                    out_channels=cfg.out_channels,
                    num_attention_heads=cfg.num_attention_heads,
                    attention_head_dim=cfg.head_dim,
                    num_layers=cfg.num_hidden_layers,
                    num_embeds_ada_norm=cfg.num_classes,
                    norm_type="ada_norm_zero"),
        "vae": dict(_class_name="AutoencoderKL",
                    in_channels=vcfg.in_channels, out_channels=3,
                    latent_channels=vcfg.latent_channels,
                    block_out_channels=[vcfg.base_channels * m for m in
                                        vcfg.channel_multipliers],
                    layers_per_block=vcfg.layers_per_block,
                    norm_num_groups=vcfg.norm_groups,
                    scaling_factor=vcfg.scaling_factor)}
    d = tempfile.mkdtemp(prefix="diffusers_")
    try:
        loaded, nbytes, t_write, t_load = {}, 0, 0.0, 0.0
        for name, src in (("dit", dit_model), ("vae", ae)):
            t0 = time.perf_counter()
            nbytes += _write_diffusers(os.path.join(d, name), configs[name],
                                       hf_interop.to_hf_state_dict(src))
            t_write += time.perf_counter() - t0
            t0 = time.perf_counter()
            m = hf_interop.from_pretrained(os.path.join(d, name),
                                           dtype=torch.bfloat16, device=dev)
            torch.cuda.synchronize()
            t_load += time.perf_counter() - t0
            got, want = m.state_dict(), src.state_dict()
            bad = [k for k in want if not torch.equal(got[k], want[k])]
            if bad or set(got) != set(want):
                fail(f"[vision] (f) {name}: loaded parameters differ from "
                     f"the source's: {bad[:4]}")
            loaded[name] = m
        outs = []
        for pipe in (DiTPipeline(dit_model, ae),
                     DiTPipeline(loaded["dit"], loaded["vae"])):
            gen = torch.Generator(device=dev).manual_seed(seed)
            with ptt.amp.auto_cast(dtype="bfloat16"):
                outs.append(pipe(VISION_DIT_LABELS, num_inference_steps=2,
                                 generator=gen))
        if not torch.equal(outs[0], outs[1]):
            fail("[vision] (f) two pipeline steps on the loaded checkpoints "
                 "differ from the source pipeline's")
        log(f"[vision] (f) diffusers checkpoints (DiTTransformer2DModel at "
            f"DiT-XL/2, AutoencoderKL at the SD VAE), bf16, "
            f"{nbytes / 1e9:.2f} GB written in {t_write:.1f} s, "
            f"from_pretrained in {t_load:.1f} s: every parameter bit for bit "
            f"the source's, 2 pipeline steps bit for bit the source "
            f"pipeline's [{card}]")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _vision_bf16(seed, dev, card, dit_model, ae, sd3_model, sd3_ae,
                 sd3_args):
    """(g) each family's bf16 forward against its fp32 twin (the same
    weights) on the card, and one DiTBlock, one VAE ResnetBlock and one
    ConvBNLayer alone. TF32 is off (cuDNN convolutions too)."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import clip, dit, ppocr, resnet, vae, vit
    rs = np.random.RandomState(seed + 350)
    bf = torch.bfloat16
    errs = {}

    def rnd(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev)
    with torch.no_grad():
        cfg = dit_model.config
        g = cfg.input_size
        lat = rnd(4, cfg.in_channels, g, g)
        t = torch.tensor([1, 250, 600, 999], device=dev)
        y = torch.tensor(VISION_DIT_LABELS, device=dev)
        twin = _fp32_twin(dit_model, dit.DiT, cfg)
        h = rnd(4, (g // cfg.patch_size) ** 2, cfg.hidden_size)
        cond = rnd(4, cfg.hidden_size)
        with ptt.amp.auto_cast(dtype="bfloat16"):
            out = dit_model(lat, t, y)
            blk = dit_model.blocks[0](h.to(bf), cond.to(bf))
        errs["DiT-XL/2"] = _rel_err(out, twin(lat, t, y))
        errs["DiTBlock"] = _rel_err(blk, twin.blocks[0](h, cond))
        del twin
        twin = _fp32_twin(ae, vae.AutoencoderKL, ae.config)
        z = rnd(2, ae.config.latent_channels, g, g)
        with ptt.amp.auto_cast(dtype="bfloat16"):
            out = ae.decode(z)
        errs["SD VAE decode"] = _rel_err(out, twin.decode(z))
        mid = ae.config.base_channels * ae.config.channel_multipliers[-1]
        hh = rnd(2, mid, g, g)
        errs["VAE ResnetBlock"] = _rel_err(ae.decoder.mid[0](hh.to(bf)),
                                           twin.decoder.mid[0](hh))
        del twin
        scfg = sd3_model.config
        twin = _fp32_twin(sd3_model, dit.MMDiT, scfg)
        lat16 = rnd(1, scfg.in_channels, scfg.input_size, scfg.input_size)
        ctx, pooled = sd3_args
        t1 = torch.tensor([500], device=dev)
        with ptt.amp.auto_cast(dtype="bfloat16"):
            out = sd3_model(lat16, t1, ctx, pooled)
        errs["MMDiT"] = _rel_err(out, twin(lat16, t1, ctx, pooled))
        del twin, out
        twin = _fp32_twin(sd3_ae, vae.AutoencoderKL, sd3_ae.config)
        with ptt.amp.auto_cast(dtype="bfloat16"):
            out = sd3_ae.decode(lat16)
        errs["VAE-16 decode"] = _rel_err(out, twin.decode(lat16))
        del twin
        gc.collect()
        torch.cuda.empty_cache()
        for name, cls, cfg in (
                ("ViT-B/16", vit.ViTForImageClassification,
                 vit.vit_base_patch16_224(dtype=bf)),
                ("ResNet-50", resnet.ResNet,
                 resnet.ResNetConfig(depth=50, dtype=bf))):
            m = _noised(cls(cfg, device=dev,
                            generator=ptt.make_generator(seed + 351, dev)),
                        seed + 352).eval()
            t32 = _fp32_twin(m, cls, cfg)
            size = getattr(cfg, "image_size", 224)
            px = rnd(8, 3, size, size)
            errs[name] = _rel_err(m(px.to(bf)), t32(px))
            if name == "ResNet-50":
                w = cfg.stem_width
                xb = rnd(8, w, 56, 56)
                errs["ConvBNLayer"] = _rel_err(
                    m.stages[0][0].conv1(xb.to(bf)),
                    t32.stages[0][0].conv1(xb))
            del m, t32
        ccfg = clip.CLIPConfig()
        ccfg.text.dtype = ccfg.vision.dtype = bf
        m = _noised(clip.CLIPModel(ccfg, device=dev,
                                   generator=ptt.make_generator(seed + 353,
                                                                dev)),
                    seed + 354).eval()
        ids = torch.from_numpy(rs.randint(
            1, ccfg.text.vocab_size - 1,
            (8, ccfg.text.max_position_embeddings))).to(dev)
        size = ccfg.vision.image_size
        px = rnd(8, 3, size, size)
        errs["CLIP"] = _rel_err(m(ids, px.to(bf))[0],
                                _fp32_twin(m, clip.CLIPModel, ccfg)(ids,
                                                                    px)[0])
        del m
        scfg = ppocr.SVTRConfig(dtype=bf)
        for name, cls, cfg, x in (
                ("DBNet", ppocr.DBNet, ppocr.DBNetConfig(dtype=bf),
                 rnd(2, 3, 640, 640)),
                ("SVTR", ppocr.SVTRNet, scfg,
                 rnd(8, 3, scfg.img_height, scfg.img_width))):
            m = _noised(cls(cfg, device=dev,
                            generator=ptt.make_generator(seed + 355, dev)),
                        seed + 356).eval()
            out, ref = m(x.to(bf)), _fp32_twin(m, cls, cfg)(x)
            if name == "DBNet":
                out, ref = out["maps"], ref["maps"]
            errs[name] = _rel_err(out, ref)
            del m
    blocks = ("DiTBlock", "VAE ResnetBlock", "ConvBNLayer")
    log("[vision] (g) bf16 against fp32 on the same weights (relative l2; "
        "TF32 off): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tolerance: a model {TOL_VISION_MODEL}, a block "
        f"{TOL_VISION_BLOCK}) [{card}]")
    bad = {k: v for k, v in errs.items()
           if not v < (TOL_VISION_BLOCK if k in blocks else TOL_VISION_MODEL)}
    if bad:
        fail(f"[vision] (g) bf16 outside its tolerance of fp32: {bad}")


def phase_vision(seed, dev, card):
    """Phase 20 (module docstring). Returns the launches of the
    main-path runs by kernel key."""
    dit_model, ae, _ = _vision_dit(seed, dev, card)
    sd3_model, sd3_ae, sd3_args = _vision_sd3(seed, dev, card)
    _vision_bf16(seed, dev, card, dit_model, ae, sd3_model, sd3_ae, sd3_args)
    del sd3_model, sd3_ae, sd3_args
    gc.collect()
    torch.cuda.empty_cache()
    _vision_diffusers(dit_model, ae, dev, card, seed + 360)
    del dit_model, ae
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict.fromkeys(NO_LAUNCHES, 0)
    launches["fused_adamw"] = (_vision_vit_clip(seed, dev, card)
                               + _vision_resnet(seed, dev, card)
                               + _vision_ocr(seed, dev, card))
    log(f"[vision] launches of the phase's main-path runs {launches} "
        f"[{card}]")
    return launches



# phase 21: the fused-qkv families on a tp mesh. GPT-1.3B's per-rank
# shapes at tp 2 and 4: the flash kernels' q [4, 1024, 16 / tp, 128]
# (causal, the Trainer's and prefill's), and its four projections a rank
# (label, din of the rank's codes, dout of the rank's codes, scale blocks
# of the whole table, the rank whose blocks are read: a row layer's last)
TPZ_FLASH = (("GPT-1.3B tp 2", (4, 1024, 8, 128), True),
             ("GPT-1.3B tp 4", (4, 1024, 4, 128), True))
TPZ_QUANT = (("qkv col tp 2", 2048, 3072, 16, 0),
             ("qkv col tp 4", 2048, 1536, 16, 0),
             ("out row tp 2", 1024, 2048, 16, 1),
             ("out row tp 4", 512, 2048, 16, 3),
             ("fc_in col tp 2", 2048, 4096, 16, 0),
             ("fc_in col tp 4", 2048, 2048, 16, 0),
             ("fc_out row tp 2", 4096, 2048, 64, 1),
             ("fc_out row tp 4", 2048, 2048, 64, 3))
TPZ_NEW = 64
TPZ_VIT_BATCH = 16
TPZ_DIT_BATCH = 8
TPZ_RESNET_BATCH = 16


def _tpz_gpt(seed, dev, card):
    """(a) GPT-1.3B twice from the seed: plain, and built inside
    ``sharded_build`` on the world-one mesh (its fused qkv tagged as three
    blocks, ``fused_parts``), cut by ``shard_layer`` and bound once;
    greedy ``generate()`` and the int8 weight-only ``Predictor`` bit for
    bit the plain model's, then 3 Trainer steps each (AdamW, fp32
    masters): the sharded model's losses the plain model's. Returns the
    sharded paths' launches."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.parallel.sharding import (bind_static, local,
                                                    shard_layer,
                                                    sharded_build)
    cfg = ptt.GPTConfig()
    L = cfg.num_hidden_layers

    def build(sharded, seed_=seed + 400, **kw):
        if not sharded:
            return ptt.GPTForCausalLM(
                cfg, device=dev, generator=ptt.make_generator(seed_, dev))
        with sharded_build(**kw):
            m = ptt.GPTForCausalLM(
                cfg, device=dev, generator=ptt.make_generator(seed_, dev))
        shard_layer(m, **kw)
        return m

    serve = dict(fsdp_min_size=1 << 30)
    plain, sharded = build(False), build(True, **serve)
    bind_static(sharded)
    qkv = sharded.model.layers[0].attn.qkv_proj
    same = all(torch.equal(a, local(b)) for a, b in zip(
        plain.parameters(), sharded.parameters()))
    log(f"[tp-zoo] (a) GPT-1.3B ({L} layers of {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads of {cfg.head_dim}) twice from "
        f"seed {seed + 400}: plain, and built sharded on the world-one "
        f"mesh (qkv fused_parts {qkv._parameters['weight'].fused_parts}: "
        f"at tp > 1 a rank holds its heads' q, k and v rows; at tp 1 the "
        f"split is the identity): weights equal {same}")
    if not same:
        fail("tp-zoo (a): the sharded GPT's weights are not the plain ones")
    ids = torch.randint(0, cfg.vocab_size, ZOO_PROMPT, device=dev,
                        generator=ptt.make_generator(seed + 401, dev))
    launches = dict.fromkeys(NO_LAUNCHES, 0)
    outs = {}
    for arm, m in (("plain", plain), ("sharded", sharded)):
        pred = ptt.Predictor(m, device=dev)
        outs[arm], _, _ = _zoo_generate(ptt, pred, ids, TPZ_NEW,
                                        f"(a) {arm} bf16", card,
                                        tag="[tp-zoo]")
        del pred
    if not torch.equal(outs["plain"], outs["sharded"]):
        fail("tp-zoo (a): the sharded GPT's greedy tokens differ from the "
             "plain model's")
    del plain, sharded
    gc.collect()
    torch.cuda.empty_cache()
    for arm in ("plain", "sharded"):
        m = build(arm == "sharded", **serve)
        if arm == "sharded":
            bind_static(m)
        pred = ptt.Predictor(m, ptt.Config().enable_weight_only_quant(8),
                             device=dev)
        outs[arm], _, got = _zoo_generate(
            ptt, pred, ids, TPZ_NEW, f"(a) {arm} int8", card,
            quant=GPT_PER_LAYER * L, tag="[tp-zoo]")
        if arm == "sharded":
            for k, v in got.items():
                launches[k] += v
        del pred, m
        gc.collect()
        torch.cuda.empty_cache()
    if not torch.equal(outs["plain"], outs["sharded"]):
        fail("tp-zoo (a): the sharded GPT's int8 tokens differ from the "
             "plain model's")
    log(f"[tp-zoo] (a) generate 4 x 512 + {TPZ_NEW}, greedy, bf16 and int8 "
        f"weight-only: the sharded model's tokens bit for bit the plain "
        f"model's [{card}]")
    rs = np.random.RandomState(seed + 402)
    batch = rs.randint(0, cfg.vocab_size, ZOO_TRAIN)
    losses = {}
    for arm in ("plain", "sharded"):
        m = build(arm == "sharded", seed_=seed + 403)
        tr = _zoo_trainer(ptt, m, [batch], ZOO_STEPS, 1e-3)
        tr.args.output_dir = "output/chip_smoke_tp_zoo"
        want = dict(NO_LAUNCHES, flash=L * ZOO_STEPS,
                    flash_bwd_dq=L * ZOO_STEPS, flash_bwd_dkv=L * ZOO_STEPS,
                    fused_adamw=_update_launches(m, ZOO_STEPS))
        got, _ = _zoo_train_run(
            tr, ZOO_STEPS, f"(a) GPT-1.3B {arm} train [{ZOO_TRAIN[0]}, "
            f"{ZOO_TRAIN[1]}]", want, card, tokens=ZOO_TRAIN[0] * ZOO_TRAIN[1],
            tag="[tp-zoo]")
        losses[arm] = [v for _, v in tr.logger.history["loss"]]
        if arm == "sharded":
            for k, v in got.items():
                launches[k] += v
        del tr, m
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[tp-zoo] (a) 3 Trainer steps: plain losses "
        + ", ".join(f"{x:.6f}" for x in losses["plain"]) + "; sharded "
        + ", ".join(f"{x:.6f}" for x in losses["sharded"])
        + f"; bit for bit {losses['plain'] == losses['sharded']} [{card}]")
    if losses["plain"] != losses["sharded"]:
        fail("tp-zoo (a): the sharded GPT's Trainer losses differ from the "
             "plain model's")
    return launches


def _tpz_vision(seed, dev, card):
    """(c) ViT-B/16 and DiT-XL/2 twice from the seed in bf16, plain and
    built sharded on the world-one mesh: one eval forward and one
    denoising step bit for bit the plain model's."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import dit, vit
    from paddle_tpu_torch.parallel.sharding import (bind_static,
                                                    shard_layer,
                                                    sharded_build)
    bf = torch.bfloat16
    gen = ptt.make_generator(seed + 410, dev)
    cases = (
        ("ViT-B/16", lambda g: vit.ViTForImageClassification(
            vit.vit_base_patch16_224(dtype=bf), device=dev, generator=g),
         lambda: (torch.randn(TPZ_VIT_BATCH, 3, 224, 224, generator=gen,
                              device=dev).to(bf),)),
        ("DiT-XL/2", lambda g: dit.DiT(dit.dit_xl_2(dtype=bf), device=dev,
                                       generator=g),
         lambda: (torch.randn(TPZ_DIT_BATCH, 4, 32, 32, generator=gen,
                              device=dev).to(bf),
                  torch.randint(0, 1000, (TPZ_DIT_BATCH,), generator=gen,
                                device=dev),
                  torch.randint(0, 1000, (TPZ_DIT_BATCH,), generator=gen,
                                device=dev))))
    for label, make, inputs in cases:
        # seeded noise on both (adaLN-Zero would make DiT's output zero)
        with torch.no_grad():
            plain = _noised(make(ptt.make_generator(seed + 411, dev)),
                            seed + 412).eval()
            with sharded_build(fsdp_min_size=1 << 30):
                sharded = _noised(make(ptt.make_generator(seed + 411, dev)),
                                  seed + 412)
        shard_layer(sharded, fsdp_min_size=1 << 30)
        bind_static(sharded)
        sharded.eval()
        args = inputs()
        with torch.no_grad():
            a, b = plain(*args), sharded(*args)
        torch.cuda.synchronize()
        what = "eval logits" if label.startswith("ViT") else \
            "denoising step's output"
        log(f"[tp-zoo] (c) {label} bf16, plain and built sharded on the "
            f"world-one mesh: one {what} {list(a.shape)}, bit for bit "
            f"{torch.equal(a, b)} [{card}]")
        if not torch.equal(a, b):
            fail(f"tp-zoo (c): the sharded {label}'s {what} differs from "
                 f"the plain model's")
        del plain, sharded, a, b
        gc.collect()
        torch.cuda.empty_cache()


def _tpz_resnet(seed, dev, card):
    """(d) ResNet-50, bf16, one Trainer step through the BatchNorm that
    all-reduces its statistics over the data axes, at a world of one: no
    collective issued (``nn.norm.stat_reductions``), the parameters bit
    for bit a step through the per-rank statistics of the layer before
    the all-reduce (``functional.batch_norm`` without ``ranks``)."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import norm
    rs = np.random.RandomState(seed + 420)
    px = torch.from_numpy(rs.randn(TPZ_RESNET_BATCH, 3, 224, 224)
                          .astype(np.float32)).to(dev, torch.bfloat16)
    labels = torch.from_numpy(rs.randint(0, 1000, TPZ_RESNET_BATCH)).to(dev)
    params = {}
    real = F.batch_norm
    for arm in ("global", "local"):
        model = resnet.resnet50(device=dev, dtype=torch.bfloat16,
                                generator=ptt.make_generator(seed + 421,
                                                             dev))
        tr = _zoo_trainer(ptt, model, [{"px": px, "labels": labels}], 1,
                          VISION_LR, loss_fn=lambda m, b: F.cross_entropy(
                              m(b["px"]), b["labels"]))
        tr.args.output_dir = "output/chip_smoke_tp_zoo"
        before = norm.stat_reductions
        if arm == "local":
            # the layer's statistics as computed before the all-reduce
            def local_only(*a, ranks=1, axes=(), **kw):
                return real(*a, **kw)
            F.batch_norm = local_only
        try:
            tr.train()
        finally:
            F.batch_norm = real
        torch.cuda.synchronize()
        issued = norm.stat_reductions - before
        params[arm] = {k: v.detach().clone()
                       for k, v in model.named_parameters()}
        if arm == "global":
            log(f"[tp-zoo] (d) ResNet-50 bf16, one Trainer step on "
                f"[{TPZ_RESNET_BATCH}, 3, 224, 224] at a world of one: "
                f"statistics all-reduces issued {issued} (a degree of 1 "
                f"issues none) [{card}]")
            if issued:
                fail(f"tp-zoo (d): {issued} statistics all-reduces at a "
                     f"world of one")
        del tr, model
        gc.collect()
        torch.cuda.empty_cache()
    same = all(torch.equal(params["global"][k], params["local"][k])
               for k in params["global"])
    log(f"[tp-zoo] (d) the step's {len(params['global'])} parameters bit "
        f"for bit the per-rank statistics' step: {same} [{card}]")
    if not same:
        fail("tp-zoo (d): ResNet-50's step differs from the step through "
             "the per-rank statistics")


def phase_tp_zoo(seed, gen, dev, card):
    """Phase 21 (module docstring). Returns the launches of the main-path
    runs by kernel key."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import env
    t0 = time.perf_counter()
    launches = dict.fromkeys(NO_LAUNCHES, 0)
    _zoo_flash(gen, dev, card, shapes=TPZ_FLASH, tag="[tp-zoo] (b)")
    _tp_quant(gen, dev, card, table=TPZ_QUANT, tag="[tp-zoo] (b)",
              rows_m=(4,))
    mesh = env.init_parallel_env({"tp": 1})
    try:
        log(f"[tp-zoo] world-one mesh {mesh.shape} over "
            f"{dist.get_backend()} (world {dist.get_world_size()})")
        for k, v in _tpz_gpt(seed, dev, card).items():
            launches[k] += v
        _tpz_vision(seed, dev, card)
        _tpz_resnet(seed, dev, card)
    finally:
        env.clear_mesh()
        dist.destroy_process_group()
    log(f"[tp-zoo] phase {time.perf_counter() - t0:.1f} s; launches of its "
        f"main-path runs {launches} [{card}]")
    return launches

# ------------------------------------------------------------------ [api]
API_LAYERS = TRAIN_LAYERS        # Llama-3-8B's widths, cut to 4 layers
API_BATCH = TRAIN_BATCH          # [2, 2048], one forward and backward a step
API_STEPS = 3                    # timed steps of each model, in turns
# relative error past which (a) fails where it is not bit for bit: one
# bf16 rounding step (2^-8) amplified through 4 layers and a backward
TOL_API_REL = 2e-2
# the masked call (dense attention, fp32 softmax) against the flash route
# (its own rounding points) over the 4 layers, relative to the largest
TOL_API_MASKED = 2.0 ** -4
API_IMAGE = (256, 256, 3)        # (b) FakeData's HWC images
API_FIT_BATCH = 32
API_FIT_STEPS = 4
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# (d) the card against the CPU in fp32 (TF32 off): a few ulps of a sum
# or of a transcendental, relative to max(1, |value|)
TOL_API_SWEEP = 1e-4
# the port's Llama decoder layer's names -> the [api] decoder's
API_RENAME = {"input_layernorm.weight": "input_norm_weight",
              "post_attention_layernorm.weight": "post_norm_weight",
              **{f"self_attn.{p}_proj.weight": f"{p}_proj.weight"
                 for p in "qkvo"},
              **{f"mlp.{p}_proj.weight": f"{p}_proj.weight"
                 for p in ("gate", "up", "down")}}


def api_decoder(cfg, device=None, layers=None):
    """A PaddleNLP-style Llama decoder written against the public API
    only: an ``nn.Layer`` subclass of ``nn.Linear`` projections and
    ``create_parameter`` norm weights whose forward calls
    ``incubate.nn.functional``'s ``fused_rms_norm``,
    ``fused_rotary_position_embedding`` (cos / sin tables [max_pos, d /
    2] gathered at ``position_ids``), ``fused_dot_product_attention(
    is_causal=True)``, ``swiglu`` and ``fused_dropout_add`` at p 0.
    ``load_from(llama)`` copies the weights of the port's
    ``LlamaForCausalLM`` decoder layers (``API_RENAME``)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import initializer as I
    h, d, dt = cfg.hidden_size, cfg.head_dim, cfg.dtype
    nh, kvh = cfg.num_attention_heads, cfg.num_key_value_heads

    class DecoderLayer(nn.Layer):
        def __init__(self):
            super().__init__()
            kw = dict(bias_attr=False, device=device, dtype=dt)
            self.q_proj = nn.Linear(h, nh * d, **kw)
            self.k_proj = nn.Linear(h, kvh * d, **kw)
            self.v_proj = nn.Linear(h, kvh * d, **kw)
            self.o_proj = nn.Linear(nh * d, h, **kw)
            self.gate_proj = nn.Linear(h, cfg.intermediate_size, **kw)
            self.up_proj = nn.Linear(h, cfg.intermediate_size, **kw)
            self.down_proj = nn.Linear(cfg.intermediate_size, h, **kw)
            ones = I.Constant(1.0)
            self.input_norm_weight = self.create_parameter(
                [h], dt, ones, device=device)
            self.post_norm_weight = self.create_parameter(
                [h], dt, ones, device=device)

        def forward(self, x, cos, sin, position_ids, attn_mask=None):
            b, s, _ = x.shape
            y = IF.fused_rms_norm(x, self.input_norm_weight,
                                  epsilon=cfg.rms_norm_eps)
            q = self.q_proj(y).reshape(b, s, nh, d)
            k = self.k_proj(y).reshape(b, s, kvh, d)
            v = self.v_proj(y).reshape(b, s, kvh, d)
            q, k, _ = IF.fused_rotary_position_embedding(
                q, k, None, sin=sin, cos=cos, position_ids=position_ids)
            a = IF.fused_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                               is_causal=True)
            x = IF.fused_dropout_add(self.o_proj(a.reshape(b, s, nh * d)),
                                     x, p=0.0)
            y = IF.fused_rms_norm(x, self.post_norm_weight,
                                  epsilon=cfg.rms_norm_eps)
            return IF.fused_dropout_add(
                self.down_proj(IF.swiglu(self.gate_proj(y), self.up_proj(y))),
                x, p=0.0)

    class Decoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.layers = nn.LayerList(
                [DecoderLayer() for _ in range(layers or
                                               cfg.num_hidden_layers)])

        def forward(self, x, cos, sin, position_ids, attn_mask=None):
            for layer in self.layers:
                x = layer(x, cos, sin, position_ids, attn_mask)
            return x

        def load_from(self, llama):
            state = {}
            for i, _ in enumerate(self.layers):
                src = llama.model.layers[i].state_dict()
                state.update({f"layers.{i}.{API_RENAME[k]}": v
                              for k, v in src.items()})
            self.set_state_dict(state)
            return self

    return Decoder()


def api_rope_tables(llama, max_pos):
    """The Llama model's RoPE as [max_pos, d / 2] cos and sin tables
    (``rotary_cos_sin`` over every position, its own schedule)."""
    from paddle_tpu_torch.models.llama import rotary_cos_sin
    m, cfg = llama.model, llama.config
    pos = torch.arange(max_pos, device=m.rope_inv_freq.device)[None]
    cos, sin = rotary_cos_sin(pos, cfg.head_dim, cfg.rope_theta, cfg.dtype,
                              inv_freq=m.rope_inv_freq,
                              attention_scaling=m.attn_scaling)
    return cos.reshape(max_pos, -1), sin.reshape(max_pos, -1)


def _api_rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _api_decoder_run(seed, dev, card):
    """(a) The API-written decoder at Llama-3-8B's widths (4 layers, bf16,
    [2, 2048]) against the port's own Llama layers on its weights."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.llama import rotary_cos_sin
    cfg = ptt.llama3_8b(num_hidden_layers=API_LAYERS)
    llama = ptt.LlamaForCausalLM(cfg, device=dev,
                                 generator=ptt.make_generator(seed + 131,
                                                              dev))
    ptt.seed(seed)
    api = api_decoder(cfg, dev).load_from(llama)
    b, s = API_BATCH
    gen = ptt.make_generator(seed + 132, dev)
    x0 = torch.randn(b, s, cfg.hidden_size, generator=gen, device=dev,
                     dtype=cfg.dtype)
    cot = torch.randn(b, s, cfg.hidden_size, generator=gen, device=dev,
                      dtype=cfg.dtype)
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    cos, sin = api_rope_tables(llama, s)
    m = llama.model
    rope = rotary_cos_sin(pos, cfg.head_dim, cfg.rope_theta, cfg.dtype,
                          inv_freq=m.rope_inv_freq,
                          attention_scaling=m.attn_scaling)
    ref_params = dict(m.layers.named_parameters())

    def api_step():
        x = x0.detach().requires_grad_(True)
        out = api(x, cos, sin, pos)
        out.backward(cot)
        return out.detach(), x.grad

    def ref_step():
        x = x0.detach().requires_grad_(True)
        h = x
        for layer in m.layers:
            h = layer(h, rope)
        h.backward(cot)
        return h.detach(), x.grad

    read = _reset_launches()
    out, gx = api_step()
    launches = read()
    routes = _check_routes("api (a)", flash=API_LAYERS,
                           flash_bwd_dq=API_LAYERS,
                           flash_bwd_dkv=API_LAYERS)
    want = dict(NO_LAUNCHES, flash=API_LAYERS, flash_bwd_dq=API_LAYERS,
                flash_bwd_dkv=API_LAYERS)
    api_grads = {n: p.grad for n, p in api.named_parameters()}
    ref_out, ref_gx = ref_step()
    pairs = [("out", out, ref_out), ("d x", gx, ref_gx)]
    for name, p in ref_params.items():
        i, rest = name.split(".", 1)
        pairs.append((f"d {name}", api_grads[f"layers.{i}.{API_RENAME[rest]}"],
                      p.grad))
    same = {n: torch.equal(a, r) for n, a, r in pairs}
    rel = max(_api_rel(a, r) for _, a, r in pairs)
    # in turns: the API model's step and the Llama layers' step
    t_api, t_ref = [], []
    for _ in range(API_STEPS):
        for fn, sink in ((api_step, t_api), (ref_step, t_ref)):
            api.zero_grad(set_to_none=True)
            m.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0) * 1e3)
    ms_api, ms_ref = sorted(t_api)[API_STEPS // 2], \
        sorted(t_ref)[API_STEPS // 2]
    # the masked call: the dense route, no flash kernel
    mask = torch.ones(b, 1, 1, s, dtype=torch.bool, device=dev)
    with torch.no_grad():
        read = _reset_launches()
        masked = api(x0, cos, sin, pos, attn_mask=mask)
        masked_launches = read()
    masked_rel = _api_rel(masked, out)
    bit = all(same.values())
    log(f"[api] (a) a PaddleNLP-style decoder (nn.Layer subclass: nn.Linear, "
        f"create_parameter, incubate.nn.functional fused_rms_norm, "
        f"fused_rotary_position_embedding on [{s}, {cfg.head_dim // 2}] "
        f"tables, fused_dot_product_attention(is_causal=True), swiglu, "
        f"fused_dropout_add p 0) at Llama-3-8B's widths, {API_LAYERS} "
        f"layers, bf16 [{b}, {s}], weights from the port's "
        f"LlamaForCausalLM layers: outputs and gradients against those "
        f"layers bit for bit: {bit} ({sum(same.values())} of {len(same)} "
        f"tensors equal; max relative error {rel:.3g}, tol {TOL_API_REL}); "
        f"launches a step {launches} (want {want}), by route {routes}; a "
        f"step {ms_api:.2f} ms (median of {API_STEPS}) against the Llama "
        f"layers' {ms_ref:.2f} ms, in turns [{card}]")
    log(f"[api] (a) with an attn_mask (all True, [{b}, 1, 1, {s}]): the "
        f"dense route, launches {masked_launches}, relative error against "
        f"the flash route {masked_rel:.3g} (tol {TOL_API_MASKED}) [{card}]")
    if launches != want or (not bit and rel > TOL_API_REL):
        fail(f"api (a): launches {launches} (want {want}), bit for bit "
             f"{bit}, max relative error {rel} (tol {TOL_API_REL})")
    if any(masked_launches[k] for k in ("flash", "flash_bwd_dq",
                                        "flash_bwd_dkv")) \
            or masked_rel > TOL_API_MASKED:
        fail(f"api (a) masked: launches {masked_launches}, relative error "
             f"{masked_rel}")
    del api, llama, m, ref_params, api_grads, pairs
    return launches, {"ms": ms_api, "llama_ms": ms_ref}


def _api_pipeline(T, seed):
    """The ImageNet train transform with seeded generators."""
    import numpy as np
    return T.Compose([
        T.RandomResizedCrop(224, rng=np.random.default_rng(seed)),
        T.RandomHorizontalFlip(rng=np.random.default_rng(seed + 1)),
        T.ToTensor(), T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])


def _api_reseed_worker(worker_id):
    """DataLoader ``worker_init_fn``: each random transform a stream of
    this worker's own, from its seed (the pool's base seed plus the
    worker's id, as the JAX package's workers get it); a generator given
    at construction reaches every spawned worker as the same copy."""
    import numpy as np

    from paddle_tpu_torch.io import get_worker_info
    info = get_worker_info()
    for i, t in enumerate(info.dataset.transform.transforms):
        if getattr(t, "rng", None) is not None:
            t.rng = np.random.default_rng([info.seed, i])


def _api_imagenet(seed, dev, card):
    """(b) FakeData through the ImageNet train transforms and
    ``io.DataLoader`` into ``Model(vision.resnet50())``, fp32."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision import datasets
    from paddle_tpu_torch.vision import transforms as T
    n = API_FIT_STEPS * API_FIT_BATCH
    kw = dict(num_samples=n, image_shape=API_IMAGE, num_classes=1000,
              seed=seed)
    ds = datasets.FakeData(transform=_api_pipeline(T, seed), **kw)
    t0 = time.perf_counter()
    first = next(iter(DataLoader(ds, batch_size=API_FIT_BATCH)))
    load_s = time.perf_counter() - t0
    raw = datasets.FakeData(**kw)
    hand = _api_pipeline(T, seed)
    imgs = np.stack([hand(raw[i][0]) for i in range(API_FIT_BATCH)])
    labels = np.stack([raw[i][1] for i in range(API_FIT_BATCH)])
    equal = (np.array_equal(np.asarray(first[0]), imgs)
             and np.array_equal(np.asarray(first[1]), labels)
             and imgs.shape == (API_FIT_BATCH, 3, 224, 224))
    net = ptt.vision.resnet50(device=dev)
    model = ptt.Model(net).prepare(ptt.optimizer.AdamW(learning_rate=1e-4),
                                   loss=ptt.nn.CrossEntropyLoss(),
                                   metrics=ptt.metric.Accuracy())
    marks = []

    class Clock:
        def on_train_batch_end(self, step, logs):   # float(loss) synced
            marks.append(time.perf_counter())

    loader = DataLoader(datasets.FakeData(
        transform=_api_pipeline(T, seed + 7), **kw),
        batch_size=API_FIT_BATCH, num_workers=2,
        worker_init_fn=_api_reseed_worker)
    read = _reset_launches()
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    hist = model.fit(loader, epochs=1, log_freq=1, verbose=0,
                     callbacks=[Clock()])
    launches = read()
    step_ms = np.diff(marks) * 1e3
    steady = float(np.median(step_ms[1:]))
    want = dict(NO_LAUNCHES, fused_adamw=_update_launches(net,
                                                           API_FIT_STEPS))
    finite = bool(np.isfinite(hist["loss"]).all())
    log(f"[api] (b) vision.datasets.FakeData(image_shape={API_IMAGE}, "
        f"num_classes=1000) through transforms.Compose([RandomResizedCrop("
        f"224), RandomHorizontalFlip(), ToTensor(), Normalize(ImageNet)]) "
        f"(seeded generators): with num_workers=0 the first batch (loaded in "
        f"{load_s:.2f} s) equals the transforms by hand: {equal}; "
        f"io.DataLoader(batch_size={API_FIT_BATCH}, num_workers=2, each "
        f"worker's transforms reseeded from its WorkerInfo.seed) into "
        f"Model(vision.resnet50()) fp32, {API_FIT_STEPS} fit steps: losses "
        f"{[round(v, 4) for v in hist['loss']]}; a step {steady:.2f} ms "
        f"(median of steps 2-{API_FIT_STEPS}; the first {step_ms[0]:.2f} "
        f"ms), {API_FIT_BATCH / steady * 1e3:.1f} images/s; launches "
        f"{launches} (want {want}) [{card}]")
    if not equal or launches != want or not finite:
        fail(f"api (b): first batch by hand {equal}, launches {launches} "
             f"(want {want}), losses {hist['loss']}")
    del model, net
    return launches, {"ms": steady,
                      "images_per_s": API_FIT_BATCH / steady * 1e3}


def _api_beginner(seed, dev, card):
    """(c) The port's counterpart of ``examples/mnist_model_api.py`` on the
    card."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.vision.datasets import FakeData

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.flatten = nn.Flatten()
            self.fc1 = nn.Linear(3 * 16 * 16, 128)
            self.fc2 = nn.Linear(128, 10)

        def forward(self, x):
            return self.fc2(nn.functional.relu(self.fc1(self.flatten(x))))

    ptt.seed(0)
    net = Net()
    ptt.seed(0)
    twin = Net()
    same = all(torch.equal(a, b) for a, b in zip(net.parameters(),
                                                   twin.parameters()))
    text = ptt.summary(net)["text"]
    model = ptt.Model(net)
    model.prepare(ptt.optimizer.AdamW(learning_rate=1e-3),
                  loss=nn.functional.cross_entropy,
                  metrics=ptt.metric.Accuracy())
    data = FakeData(num_samples=256, image_shape=(3, 16, 16),
                    num_classes=10)
    read = _reset_launches()
    hist = model.fit(data, batch_size=32, epochs=2, log_freq=4, verbose=0)
    launches = read()
    res = model.evaluate(data, batch_size=32, verbose=0)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_api_")
    try:
        model.save(os.path.join(out_dir, "mnist", "model"))
        saved = sorted(os.listdir(os.path.join(out_dir, "mnist")))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    want = dict(NO_LAUNCHES, fused_adamw=_update_launches(net, 16))
    ok = (same and launches == want and saved
          and np.isfinite(hist["loss"]).all() and np.isfinite(res["loss"]))
    log(f"[api] (c) the beginner path on the card: seed(0); Net(nn.Layer) "
        f"with nn.Flatten twice, the same weights: {same}; summary "
        f"{text.splitlines()[-1].strip()}; Model(net).prepare(AdamW, "
        f"F.cross_entropy, metric.Accuracy()).fit(FakeData(256, (3, 16, "
        f"16)), batch_size=32, epochs=2, log_freq=4): losses "
        f"{[round(v, 4) for v in hist['loss']]}; evaluate {res}; save -> "
        f"{saved}; launches {launches} (want {want}) [{card}]")
    if not ok:
        fail(f"api (c): same weights {same}, launches {launches} (want "
             f"{want}), saved {saved}, losses {hist['loss']}, evaluate {res}")
    return launches


def _api_sweep_cases(rs):
    """(d) name -> (args, kwargs) of every function ``nn.functional``
    gained in this slice but the random ones; numpy float32 arrays are
    the inputs."""
    import numpy as np

    def f(*s, lo=None, hi=None):
        if lo is not None:
            return rs.uniform(lo, hi, s).astype(np.float32)
        return rs.randn(*s).astype(np.float32)
    x = f(2, 8, 6, 6)
    unpool = torch.nn.functional.max_pool2d(torch.from_numpy(f(1, 2, 8, 8)),
                                            2, 2, return_indices=True)
    acts = ("relu6", "leaky_relu", "elu", "selu", "celu", "swish", "mish",
            "hardswish", "hardsigmoid", "hardtanh", "hardshrink",
            "softshrink", "tanhshrink", "softplus", "softsign",
            "log_sigmoid", "thresholded_relu")
    cases = {a: ([x * 3], {}) for a in acts}
    ints = lambda hi, *s: rs.randint(0, hi, s).astype(np.int64)  # noqa
    cases.update({
        "prelu": ([x, f(1, 8, 1, 1, lo=0.1, hi=0.4)], {}),
        "softmax": ([x], {"axis": 1}), "log_softmax": ([x], {}),
        "glu": ([x], {"axis": 1}), "swiglu": ([x, f(2, 8, 6, 6)], {}),
        "pixel_shuffle": ([x, 2], {}), "pixel_unshuffle": ([x, 2], {}),
        "channel_shuffle": ([x, 4], {}),
        "unfold": ([x, 3, 2, 1, 1], {}),
        "fold": ([f(2, 27, 16), (8, 7), 3, 2, 1, 1], {}),
        "softmax_with_cross_entropy": ([f(5, 7), ints(7, 5)], {}),
        "cosine_similarity": ([x, f(2, 8, 6, 6)], {"axis": 1}),
        "one_hot": ([ints(5, 3, 4), 5], {}),
        "label_smooth": ([np.eye(5, dtype=np.float32)[[1, 3]]], {}),
        "temporal_shift": ([f(6, 8, 2, 2), 3], {}),
        "pad": ([x, [1, 2, 2, 1]], {"mode": "reflect"}),
        "zeropad2d": ([x, (1, 2, 3, 4)], {}),
        "max_pool1d": ([f(2, 3, 12), 3, 2, 1], {}),
        "avg_pool1d": ([f(2, 3, 12), 3, 2, 1], {}),
        "max_pool3d": ([f(1, 2, 6, 6, 6), 2, 2], {}),
        "avg_pool3d": ([f(1, 2, 5, 6, 6), 3, 2, 1], {}),
        "adaptive_avg_pool1d": ([f(2, 3, 12), 4], {}),
        "max_unpool2d": ([unpool[0].numpy(), unpool[1].numpy(), 2, 2], {}),
        "affine_grid": ([f(2, 2, 3), (2, 3, 5, 7)], {}),
        "grid_sample": ([x, f(2, 4, 3, 2, lo=-1.2, hi=1.2)], {}),
        "local_response_norm": ([x, 5], {}),
        "sequence_mask": ([ints(5, 3)], {"maxlen": 6}),
        "bilinear": ([f(3, 6), f(3, 7), f(5, 6, 7), f(5)], {}),
        "maxout": ([x, 2], {}),
        "square_error_cost": ([f(4, 3), f(4, 3)], {}),
        "log_loss": ([f(4, 1, lo=0.05, hi=0.95),
                      (rs.rand(4, 1) > 0.5).astype(np.float32)], {}),
        "sigmoid_focal_loss": ([f(4, 3),
                                (rs.rand(4, 3) > 0.5).astype(np.float32)],
                               {}),
        "dice_loss": ([f(3, 4, 5, lo=0.01, hi=1.0), ints(5, 3, 4, 1)], {}),
        "npair_loss": ([f(6, 4), f(6, 4), ints(3, 6)], {}),
        "margin_cross_entropy": ([f(5, 7, lo=-0.9, hi=0.9), ints(7, 5)],
                                 {"scale": 8.0}),
    })
    return cases


def _api_sweep_layers(rs):
    """(d) the layers this slice added but the random ones: (class, args,
    kwargs, inputs)."""
    import numpy as np

    def f(*s):
        return rs.randn(*s).astype(np.float32)
    x = f(2, 8, 6, 6)
    unpool = torch.nn.functional.max_pool2d(torch.from_numpy(f(1, 2, 8, 8)),
                                            2, 2, return_indices=True)
    acts = ("ReLU6", "Swish", "Mish", "LogSigmoid", "Tanhshrink",
            "Hardswish", "Hardsigmoid", "Hardtanh", "Hardshrink",
            "Softshrink", "Softplus", "Softsign", "ELU", "SELU", "CELU",
            "LeakyReLU", "LogSoftmax", "Identity", "Flatten",
            "ThresholdedReLU")
    rows = [(a, (), {}, [x]) for a in acts]
    rows += [("Softmax", (), {"axis": 1}, [x]), ("GLU", (), {"axis": 1}, [x]),
             ("PReLU", (8,), {}, [x]),
             ("Upsample", (), {"scale_factor": 2}, [x]),
             ("UpsamplingBilinear2D", (), {"size": (9, 11)}, [x]),
             ("PixelShuffle", (2,), {}, [x]),
             ("PixelUnshuffle", (2,), {}, [x]),
             ("ChannelShuffle", (4,), {}, [x]),
             ("Pad2D", ([1, 2, 0, 1],), {"mode": "reflect"}, [x]),
             ("Pad1D", ([2, 1],), {"mode": "replicate"}, [f(2, 3, 7)]),
             ("ZeroPad2D", (2,), {}, [x]),
             ("CosineSimilarity", (), {}, [x, f(2, 8, 6, 6)]),
             ("PairwiseDistance", (), {}, [f(5, 4), f(5, 4)]),
             ("MaxPool1D", (3, 2, 1), {}, [f(2, 3, 12)]),
             ("AvgPool1D", (3, 2, 1), {}, [f(2, 3, 12)]),
             ("MaxPool3D", (2,), {}, [f(1, 2, 4, 6, 6)]),
             ("AvgPool3D", (3, 2, 1), {}, [f(1, 2, 4, 6, 6)]),
             ("AdaptiveAvgPool1D", (3,), {}, [f(2, 3, 12)]),
             ("Fold", ((6, 6), 3), {"paddings": 1}, [f(2, 72, 36)]),
             ("Unfold", (3,), {"paddings": 1}, [x]),
             ("LocalResponseNorm", (3,), {}, [x]),
             ("Maxout", (2,), {}, [x]),
             ("Bilinear", (6, 7, 5), {}, [f(3, 6), f(3, 7)]),
             ("MaxUnPool2D", (2, 2), {},
              [unpool[0].numpy(), unpool[1].numpy()])]
    return rows


def _api_sweep(seed, dev, card):
    """(d) Each new ``F`` function and ``nn`` class once on the card and
    once on the CPU, the card held to the CPU; the random ones by their
    invariants on the card."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    def on(v, d):
        return torch.from_numpy(v).to(d) if isinstance(v, np.ndarray) else v

    def err(a, b):
        a, b = a.detach().cpu().double(), b.detach().double()
        return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())

    rs = np.random.RandomState(seed + 141)
    worst, bad = {}, []
    for name, (args, kw) in _api_sweep_cases(rs).items():
        fn = getattr(F, name)
        ref = fn(*[on(a, "cpu") for a in args], **kw)
        got = fn(*[on(a, dev) for a in args], **kw)
        if got.device.type != "cuda":
            bad.append(f"{name}: ran on {got.device}")
        worst[name] = err(got, ref)
    for cls, a, kw, inputs in _api_sweep_layers(rs):
        ptt.seed(seed)
        layer = getattr(nn, cls)(*a, **kw, **({"device": "cpu"} if cls in (
            "Bilinear", "PReLU") else {}))
        ref = layer(*[on(v, "cpu") for v in inputs])
        got = layer.to(dev)(*[on(v, dev) for v in inputs])
        worst[cls] = err(got, ref)
    # the random ones, on the card: their invariants
    gen = ptt.make_generator(seed + 142, dev)
    p = 0.3
    xs = torch.rand(64, 64, 3, 3, device=dev, generator=gen) + 0.5
    d2 = F.dropout2d(xs, p, generator=gen).reshape(64, 64, -1)
    d3 = F.dropout3d(xs[..., None], p, generator=gen).reshape(64, 64, -1)
    for name, out in (("dropout2d", d2), ("dropout3d", d3)):
        whole = ((out == 0).all(-1) | torch.isclose(
            out, xs.reshape(64, 64, -1) / (1 - p)).all(-1)).all()
        share = float((out == 0).all(-1).float().mean())
        if not whole or abs(share - p) > 0.05:
            bad.append(f"{name}: whole channels {bool(whole)}, share {share}")
    xn = torch.randn(256, 256, device=dev, generator=gen)
    ad = F.alpha_dropout(xn, 0.2, generator=gen)
    if abs(float(ad.mean())) > 0.02 or abs(float(ad.var()) - 1) > 0.03:
        bad.append(f"alpha_dropout: mean {float(ad.mean())}, var "
                   f"{float(ad.var())}")
    rr = F.rrelu(xn, 0.1, 0.3, generator=gen)
    slope = rr[xn < 0] / xn[xn < 0]
    if float(slope.min()) < 0.1 - 1e-6 or float(slope.max()) > 0.3 + 1e-6:
        bad.append(f"rrelu: slopes {float(slope.min())}..{float(slope.max())}")
    gs = F.gumbel_softmax(torch.log(torch.tensor(
        [0.1, 0.2, 0.3, 0.4], device=dev)).expand(20000, 4), 0.5,
        hard=True, generator=gen)
    freq = gs.argmax(-1).bincount(minlength=4).float() / 20000
    if float((freq - torch.tensor([0.1, 0.2, 0.3, 0.4],
                                  device=dev)).abs().max()) > 0.02:
        bad.append(f"gumbel_softmax: frequencies {freq.tolist()}")
    for cls in ("Dropout2D", "Dropout3D", "AlphaDropout", "RReLU"):
        layer = getattr(nn, cls)(generator=gen)
        inp = {"Dropout3D": xs[..., None], "Dropout2D": xs}.get(cls, xn)
        train = layer.train()(inp)
        ev = layer.eval()(inp)
        want = F.rrelu(inp, training=False) if cls == "RReLU" else inp
        if torch.equal(train, want) or not torch.equal(ev, want):
            bad.append(f"{cls}: train mode drew nothing or eval is not "
                       f"{'the mean slope' if cls == 'RReLU' else 'x'}")
    over = {k: v for k, v in worst.items() if not v <= TOL_API_SWEEP}
    log(f"[api] (d) the sweep: {len(_api_sweep_cases(rs))} functions and "
        f"{len(_api_sweep_layers(rs))} layers on the card against the CPU, "
        f"fp32, worst relative error {max(worst.values()):.3g} "
        f"({max(worst, key=worst.get)}; tol {TOL_API_SWEEP}); the random "
        f"ones (dropout2d, dropout3d, alpha_dropout, rrelu, gumbel_softmax "
        f"and their layers) by their invariants: "
        f"{'held' if not bad else bad} [{card}]")
    if over or bad:
        fail(f"api (d): over tolerance {over}; {bad}")


def phase_api(seed, dev, card):
    """Paddle's layer API on the card (``[api]`` lines): (a) a decoder
    written against ``nn.Layer`` and ``incubate.nn.functional`` at
    Llama-3-8B's widths, held to the port's Llama layers, on the flash
    kernels; (b) the ImageNet input path through ``Model.fit``; (c) the
    beginner example; (d) a sweep of the new functions and layers, card
    against CPU. Returns the main-path launches of (a), (b) and (c)."""
    t0 = time.perf_counter()
    a_launches, a_times = _api_decoder_run(seed, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    b_launches, _ = _api_imagenet(seed, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    c_launches = _api_beginner(seed, dev, card)
    _api_sweep(seed, dev, card)
    launches = {k: a_launches[k] + b_launches[k] + c_launches[k]
                for k in a_launches}
    log(f"[api] the phase took {time.perf_counter() - t0:.1f} s; "
        f"launches of its main-path runs {launches} [{card}]")
    return launches


# --------------------------------------------------------------- [tensor]
TENSOR_LAYERS = TRAIN_LAYERS     # Llama-3-8B's widths, cut to 4 layers
TENSOR_BATCH = TRAIN_BATCH       # [2, 2048], bf16
TENSOR_STEPS = 2                 # timed steps of each route, in turns
# (a) where the functional step is not bit for bit the eager one: the
# relative error past which it fails (as TOL_API_REL: one bf16 rounding
# step amplified through 4 layers and a backward; torch.func runs some
# backward formulas as other kernels than eager autograd does)
TOL_TENSOR_REL = 2e-2
# (b) q [2 mapped, 2, 2048, 32, 128], k / v with 8 kv heads, bf16
TENSOR_VMAP = (2, 2, 2048, 32, 8, 128)
# (c) the PyLayer model's gradients, card against CPU, fp32 (TF32 off)
TOL_TENSOR_PYLAYER = 1e-4
# (d) the card against the CPU in fp32: a few ulps of a sum, a
# factorization or a transcendental, relative to max(1, |value|)
TOL_TENSOR_SWEEP = 1e-4


def _rel_max(a, b) -> float:
    """max |a - b| / max |b| in fp32 (0 for equal tensors)."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _tensor_functional(seed, dev, card):
    """(a) The JAX training idiom at Llama-3-8B's widths: ``pure_fn,
    params = model.functional()``, ``ptt.value_and_grad`` of the causal-LM
    loss, held to an eager ``loss.backward()`` on the same model and
    batch; then ``ptt.vjp`` over one decoder layer against its eager
    backward."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.llama import rotary_cos_sin
    cfg = ptt.llama3_8b(num_hidden_layers=TENSOR_LAYERS)
    model = ptt.LlamaForCausalLM(cfg, device=dev,
                                 generator=ptt.make_generator(seed + 151,
                                                              dev))
    b, s = TENSOR_BATCH
    gen = ptt.make_generator(seed + 152, dev)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    pure, params = model.functional()
    frozen = {n: p.detach() for n, p in params.items()}
    step = ptt.value_and_grad(
        lambda p: ptt.causal_lm_loss(pure(p, ids), ids))

    def eager():
        model.zero_grad(set_to_none=True)
        loss = ptt.causal_lm_loss(model(ids), ids)
        loss.backward()
        return loss.detach(), {n: q.grad for n, q in
                               model.named_parameters()}

    read = _reset_launches()
    loss, grads = step(frozen)
    torch.cuda.synchronize()
    launches = read()
    routes = _check_routes("tensor (a)", flash=TENSOR_LAYERS,
                           flash_bwd_dq=TENSOR_LAYERS,
                           flash_bwd_dkv=TENSOR_LAYERS)
    want = dict(NO_LAUNCHES, flash=TENSOR_LAYERS,
                flash_bwd_dq=TENSOR_LAYERS, flash_bwd_dkv=TENSOR_LAYERS)
    e_loss, e_grads = eager()
    pairs = [("loss", loss, e_loss)] + [(n, grads[n], e_grads[n])
                                        for n in e_grads]
    same = {n: torch.equal(a, r) for n, a, r in pairs}
    rel = {n: _rel_max(a, r) for n, a, r in pairs if not same[n]}
    worst = max(rel.values(), default=0.0)
    t_func, t_eager = [], []
    for _ in range(TENSOR_STEPS):
        for fn, sink in ((lambda: step(frozen), t_func), (eager, t_eager)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0) * 1e3)
    ms_func, ms_eager = min(t_func), min(t_eager)
    log(f"[tensor] (a) ptt.value_and_grad over model.functional() of "
        f"LlamaForCausalLM at Llama-3-8B's widths, {TENSOR_LAYERS} layers, "
        f"bf16 [{b}, {s}], against eager loss.backward(): "
        f"{sum(same.values())} of {len(same)} tensors bit for bit (loss "
        f"{'equal' if same['loss'] else 'differs'}), the others within "
        f"max relative error {worst:.3g} (tol {TOL_TENSOR_REL}; worst "
        f"{max(rel, key=rel.get) if rel else '-'}); launches a call "
        f"{launches} (want {want}), by route {routes}; a step "
        f"{ms_func:.2f} ms functional against {ms_eager:.2f} ms eager "
        f"(best of {TENSOR_STEPS}, in turns) [{card}]")
    if launches != want or worst > TOL_TENSOR_REL:
        fail(f"tensor (a): launches {launches} (want {want}), max relative "
             f"error {worst} (tol {TOL_TENSOR_REL}) in {rel}")
    del grads, e_grads, pairs, frozen
    # ptt.vjp over one decoder layer with a seeded cotangent
    layer = model.model.layers[0]
    m = model.model
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    rope = rotary_cos_sin(pos, cfg.head_dim, cfg.rope_theta, cfg.dtype,
                          inv_freq=m.rope_inv_freq,
                          attention_scaling=m.attn_scaling)
    x0 = torch.randn(b, s, cfg.hidden_size, generator=gen, device=dev,
                     dtype=cfg.dtype)
    cot = torch.randn(b, s, cfg.hidden_size, generator=gen, device=dev,
                      dtype=cfg.dtype)
    read = _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, pull = ptt.vjp(lambda x: layer(x, rope), x0)
    (gx,) = pull(cot)
    torch.cuda.synchronize()
    ms_vjp = (time.perf_counter() - t0) * 1e3
    vjp_launches = read()
    x = x0.detach().requires_grad_(True)
    e_out = layer(x, rope)
    e_out.backward(cot)
    v_same = torch.equal(out, e_out.detach()) and torch.equal(gx, x.grad)
    v_rel = max(_rel_max(out, e_out), _rel_max(gx, x.grad))
    v_want = dict(NO_LAUNCHES, flash=1, flash_bwd_dq=1, flash_bwd_dkv=1)
    log(f"[tensor] (a) ptt.vjp over decoder layer 0 with a seeded "
        f"cotangent: output and input gradient against the eager backward "
        f"bit for bit {v_same} (max relative error {v_rel:.3g}, tol "
        f"{TOL_TENSOR_REL}); launches {vjp_launches} (want {v_want}); "
        f"{ms_vjp:.2f} ms [{card}]")
    if vjp_launches != v_want or v_rel > TOL_TENSOR_REL:
        fail(f"tensor (a) vjp: launches {vjp_launches}, relative error "
             f"{v_rel}")
    for key in ("flash", "flash_bwd_dq", "flash_bwd_dkv"):
        launches[key] += vjp_launches[key]
    model.zero_grad(set_to_none=True)
    del model, m, layer, params
    return launches, {"ms": ms_func, "eager_ms": ms_eager, "vjp_ms": ms_vjp}


def _tensor_vmap(seed, dev, card):
    """(b) ``ptt.vmap`` of the flash kernel: one forward launch for the
    mapped call, bit for bit the slices; ``ptt.grad`` of the mapped sum:
    one dq and one dk/dv launch, bit for bit the slices' eager
    gradients; forward mode raises."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops.attention import flash_attention
    n, b, s, h, kv, d = TENSOR_VMAP
    gen = ptt.make_generator(seed + 153, dev)
    q, k, v = (torch.randn(n, b, s, heads, d, generator=gen, device=dev,
                           dtype=torch.bfloat16) for heads in (h, kv, kv))
    cot = torch.randn(q.shape, generator=gen, device=dev,
                      dtype=torch.bfloat16)

    def attn(q, k, v):
        return flash_attention(q, k, v, causal=True)

    read = _reset_launches()
    out = ptt.vmap(attn)(q, k, v)
    torch.cuda.synchronize()
    fwd = read()
    fwd_routes = _check_routes("tensor (b) vmap", flash=1)
    slices = all(torch.equal(out[i], attn(q[i], k[i], v[i]))
                 for i in range(n))

    def loss(q, k, v):
        return (ptt.vmap(attn)(q, k, v).float() * cot.float()).sum()
    read = _reset_launches()
    grads = ptt.grad(loss, argnums=(0, 1, 2))(q, k, v)
    torch.cuda.synchronize()
    bwd = read()
    bwd_routes = _check_routes("tensor (b) grad", flash=1, flash_bwd_dq=1,
                               flash_bwd_dkv=1)
    g_same = True
    for i in range(n):
        xs = [t[i].detach().requires_grad_(True) for t in (q, k, v)]
        (attn(*xs).float() * cot[i].float()).sum().backward()
        g_same &= all(torch.equal(g[i], x.grad) for g, x in zip(grads, xs))
    try:
        ptt.jvp(lambda q: attn(q, k[0], v[0]), (q[0],),
                (torch.ones_like(q[0]),))
        jvp_raised = None
    except NotImplementedError as e:
        jvp_raised = type(e).__name__
    want_f = dict(NO_LAUNCHES, flash=1)
    want_b = dict(NO_LAUNCHES, flash=1, flash_bwd_dq=1, flash_bwd_dkv=1)
    log(f"[tensor] (b) ptt.vmap of flash_attention(causal=True) over a "
        f"mapped axis of {n}, q [{n}, {b}, {s}, {h}, {d}], k/v {kv} heads, "
        f"bf16: launches {fwd} (want {want_f}), by route {fwd_routes}, "
        f"each slice bit for bit its own call {slices}; ptt.grad of the "
        f"mapped sum: launches {bwd} (want {want_b}), by route "
        f"{bwd_routes}, bit for bit the slices' eager gradients {g_same}; "
        f"ptt.jvp through flash raises {jvp_raised} [{card}]")
    if fwd != want_f or bwd != want_b or not slices or not g_same \
            or jvp_raised is None:
        fail(f"tensor (b): launches {fwd} / {bwd}, slices {slices}, "
             f"gradients {g_same}, jvp raised {jvp_raised}")
    return {key: fwd[key] + bwd[key] for key in fwd}


def _tensor_pylayer(seed, dev, card):
    """(c) A user ``PyLayer`` (a clipped straight-through estimator)
    inside a small ``nn.Layer``: its gradients under eager ``.backward()``
    and under ``ptt.grad`` equal, and equal to the CPU's; ``no_grad``
    inside ``ptt.grad`` cuts nothing."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import autograd, nn

    class ClippedSTE(autograd.PyLayer):
        """Ternary forward (sign where |x| > 0.5, else 0), the gradient
        passed straight through where |x| <= 1."""

        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return torch.sign(x) * (x.abs() > 0.5).to(x.dtype)

        @staticmethod
        def backward(ctx, g):
            x, = ctx.saved_tensor()
            return g * (x.abs() <= 1).to(g.dtype)

    class Quantized(nn.Layer):
        def __init__(self, device):
            super().__init__()
            self.fc1 = nn.Linear(64, 64, device=device,
                                 generator=ptt.make_generator(seed + 154,
                                                              device))
            self.fc2 = nn.Linear(64, 8, device=device,
                                 generator=ptt.make_generator(seed + 155,
                                                              device))

        def forward(self, x):
            with ptt.no_grad():
                scale = x.abs().amax() + 1
            return self.fc2(ClippedSTE.apply(self.fc1(x) / scale) * scale)

    def routes(layer, x):
        pure, params = layer.functional()
        layer.zero_grad(set_to_none=True)
        layer(x).square().sum().backward()
        eager = {n: p.grad.clone() for n, p in layer.named_parameters()}
        func = ptt.grad(lambda p: pure(p, x).square().sum())(
            {n: p.detach() for n, p in params.items()})
        return eager, func

    x = torch.randn(128, 64, generator=ptt.make_generator(seed + 156, "cpu"))
    card_l, cpu_l = Quantized(dev), Quantized("cpu")
    cpu_l.load_state_dict({k: t.cpu() for k, t in
                           card_l.state_dict().items()})
    eager, func = routes(card_l, x.to(dev))
    c_eager, c_func = routes(cpu_l, x)
    both = all(torch.equal(eager[n], func[n]) for n in eager) and \
        all(torch.equal(c_eager[n], c_func[n]) for n in c_eager)
    vs_cpu = max(_rel_max(eager[n].cpu(), c_eager[n]) for n in eager)

    def f(v):
        with ptt.no_grad():
            y = 2 * v
        return (y * v).sum()
    ng = ptt.grad(f)(torch.ones(3, device=dev)).tolist()
    log(f"[tensor] (c) a clipped straight-through ternary PyLayer in an "
        f"nn.Layer (fp32, [128, 64]): eager .backward() and ptt.grad bit for bit "
        f"on the card and on the CPU {both}; the card against the CPU "
        f"max relative error {vs_cpu:.3g} (tol {TOL_TENSOR_PYLAYER}); "
        f"no_grad inside ptt.grad gives {ng} (JAX: [4.0, 4.0, 4.0]) "
        f"[{card}]")
    if not both or vs_cpu > TOL_TENSOR_PYLAYER or ng != [4.0] * 3:
        fail(f"tensor (c): both routes equal {both}, card against CPU "
             f"{vs_cpu}, no_grad {ng}")


def _sweep_err(got, ref, bad, name):
    """The largest error of a card result against the CPU's, relative to
    max(1, |value|); a tensor off the card, a dtype, shape or integer
    value that differs is recorded in ``bad``."""
    import numpy as np
    if isinstance(ref, (tuple, list)):
        return max((_sweep_err(g, r, bad, name) for g, r in zip(got, ref)),
                   default=0.0)
    if isinstance(ref, np.ndarray):
        got, ref = torch.from_numpy(np.asarray(got)), torch.from_numpy(ref)
    elif not isinstance(ref, torch.Tensor):
        if got != ref:
            bad.append(f"{name}: {got} != {ref}")
        return 0.0
    elif got.device.type != "cuda":
        bad.append(f"{name}: ran on {got.device}")
    got = got.detach().cpu().resolve_conj()
    if got.dtype != ref.dtype or got.shape != ref.shape:
        bad.append(f"{name}: {got.dtype} {tuple(got.shape)} != "
                   f"{ref.dtype} {tuple(ref.shape)}")
        return 0.0
    if not (ref.is_floating_point() or ref.is_complex()):
        if not torch.equal(got, ref):
            bad.append(f"{name}: integer values differ")
        return 0.0
    if ref.numel() == 0:
        return 0.0
    a, r = got.to(torch.complex128), ref.to(torch.complex128)
    nan = torch.isnan(r.real) | torch.isnan(r.imag)
    if not torch.equal(nan, torch.isnan(a.real) | torch.isnan(a.imag)):
        bad.append(f"{name}: NaNs differ")
    a, r = a[~nan], r[~nan]
    inf = torch.isinf(r.real)
    if not torch.equal(a[inf], r[inf]):
        bad.append(f"{name}: infinities differ")
    a, r = a[~inf], r[~inf]
    if not r.numel():
        return 0.0
    return float(((a - r).abs() / r.abs().clamp_min(1.0)).max())


def _tensor_sweep(seed, dev, card):
    """(d) Every public function of ``tensor``, ``linalg``, ``fft``,
    ``signal``, ``audio``, ``sparse`` and ``distribution`` once on the
    card and once on the CPU, at the CPU tests' small shapes
    (``tests/tensor_cases.py``), in fp32: the deterministic ones within
    ``TOL_TENSOR_SWEEP``, the factorizations whose factors carry signs
    by reconstruction, the random ones by shape, dtype, support and
    moments; ``histogram`` and ``lstsq`` among the cases."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import audio as PAu
    from paddle_tpu_torch import distribution as PD
    from paddle_tpu_torch import fft as PF
    from paddle_tpu_torch import linalg as PL
    from paddle_tpu_torch import signal as PSg
    from paddle_tpu_torch import sparse as PSp
    from paddle_tpu_torch import tensor as P
    C = _tests_module("tensor_cases")

    def on(a, d):
        if isinstance(a, C.T):
            return torch.from_numpy(a.a.copy()).to(d)
        if isinstance(a, (list, tuple)) and any(isinstance(e, C.T)
                                                for e in a):
            return type(a)(on(e, d) for e in a)
        return a

    worst, bad = {}, []

    def held(name, fn):
        try:
            ref = fn("cpu")
            got = fn(dev)
        except Exception as e:  # a failure on either device is recorded
            bad.append(f"{name}: {type(e).__name__}: {e}")
            return
        worst[name] = _sweep_err(got, ref, bad, name)

    for cid, name, args, kw, port_kw, _ in C.TENSOR_CASES:
        held(f"tensor.{cid}", lambda d, name=name, args=args, kw=kw,
             pk=port_kw: getattr(P, name)(
                 *[on(a, d) for a in args],
                 **{k: on(a, d) for k, a in kw.items()},
                 **({"device": d} if pk else {})))
    signed = ("svd", "qr", "eig", "eigh", "pca_lowrank", "svd_lowrank")
    for cid, args, kw in C.LINALG_CASES:
        name = cid.split("-")[0]
        fn = (lambda d, name=name, args=args, kw=kw: getattr(PL, name)(
            *[on(a, d) for a in args], **{k: on(a, d) for k, a in
                                          kw.items()}))
        if cid == "eigvals-sorted":
            held(f"linalg.{cid}", lambda d, fn=fn: torch.from_numpy(
                np.sort_complex(fn(d).cpu().numpy())).to(d))
        else:
            held(f"linalg.{cid}", fn)
    for name, a in (("lu", C.A), ("lstsq", None)):
        if name == "lu":
            held("linalg.lu", lambda d: PL.lu(torch.from_numpy(a).to(d)))
            held("linalg.lu_unpack", lambda d: PL.lu_unpack(
                *PL.lu(torch.from_numpy(a).to(d))))
        else:
            deficient = np.concatenate([C.R[:, :2], C.R[:, :1] + C.R[:, 1:2]],
                                       1)
            for tag, (x, y) in (("full", (C.R, C.V[:5])),
                                ("deficient", (deficient, C.V[:5])),
                                ("matrix", (C.A, C.B))):
                held(f"linalg.lstsq-{tag}", lambda d, x=x, y=y: PL.lstsq(
                    torch.from_numpy(x).to(d), torch.from_numpy(y).to(d)))
    geq, tau = torch.geqrf(torch.from_numpy(C.R))
    held("linalg.householder_product", lambda d: PL.householder_product(
        geq.to(d), tau.to(d)))
    held("linalg.ormqr", lambda d: PL.ormqr(geq.to(d), tau.to(d),
                                            torch.ones(5, 2, device=d)))
    # the signed factorizations, on the card: by reconstruction
    Rd = torch.from_numpy(C.R).to(dev)
    SPDd = torch.from_numpy(C.SPD).to(dev)
    recon = {
        "svd": lambda: (lambda u, s_, vh: u * s_ @ vh)(*PL.svd(Rd)),
        "qr": lambda: (lambda q_, r_: q_ @ r_)(*PL.qr(Rd)),
        "eig": lambda: (lambda w, vv: (vv * w @ torch.linalg.inv(vv))
                        .real)(*PL.eig(SPDd)),
        "eigh": lambda: (lambda w, vv: vv * w @ vv.mT)(*PL.eigh(SPDd)),
    }
    for name, fn in recon.items():
        want = C.SPD if name.startswith("eig") else C.R
        worst[f"linalg.{name}-reconstruction"] = _sweep_err(
            fn(), torch.from_numpy(want), bad, name)
    low = torch.from_numpy((np.random.RandomState(seed).randn(12, 2)
                            @ np.random.RandomState(seed + 1).randn(2, 7))
                           .astype(np.float32))
    for name in signed[4:]:
        u, s_, vv = getattr(PL, name)(low.to(dev), q=3)
        base = low - low.mean(0) if name == "pca_lowrank" else low
        worst[f"linalg.{name}-reconstruction"] = _sweep_err(
            u * s_ @ vv.mT, base, bad, name)
    for cid, args, kw in C.FFT_CASES:
        name = cid.split("-")[0]
        held(f"fft.{cid}", lambda d, name=name, args=args, kw=kw: getattr(
            PF, name)(*[on(a, d) for a in args], **kw))
    for name in ("fftfreq", "rfftfreq"):
        held(f"fft.{name}", lambda d, name=name: getattr(PF, name)(
            10, 0.5, device=d))
    sig = np.random.RandomState(seed + 2).randn(2, 300).astype(np.float32)
    short = sig[:, :40].copy()
    win = torch.from_numpy(np.hanning(64).astype(np.float32))

    def sg(d, x=sig):
        return torch.from_numpy(x).to(d)
    held("signal.frame", lambda d: PSg.frame(sg(d), 64, 16))
    held("signal.overlap_add", lambda d: PSg.overlap_add(
        PSg.frame(sg(d), 64, 16), 16))
    held("signal.stft", lambda d: PSg.stft(sg(d), 64, 10,
                                           window=win.to(d)))
    held("signal.istft", lambda d: PSg.istft(PSg.stft(sg(d), 64), 64))
    held("signal.stft-short", lambda d: PSg.stft(sg(d, short), 128, 16))
    held("signal.istft-short", lambda d: PSg.istft(
        PSg.stft(sg(d, short), 128, 16), 128, 16, length=40))
    if tuple(PSg.istft(PSg.stft(sg(dev, short), 128, 16), 128, 16,
                       length=40).shape) != (2, 32):
        bad.append("signal.istft-short: length=40 did not give 32 samples")
    for w in ("hann", "hamming", "blackman", "ones"):
        held(f"audio.get_window-{w}", lambda d, w=w: PAu.get_window(
            w, 32, device=d))
    f_hz = np.array([0., 300., 1000., 4000.], np.float32)
    held("audio.hz_to_mel", lambda d: PAu.hz_to_mel(sg(d, f_hz)))
    held("audio.mel_to_hz", lambda d: PAu.mel_to_hz(sg(d, f_hz)))
    held("audio.mel_frequencies", lambda d: PAu.mel_frequencies(
        10, 20.0, 8000.0, device=d))
    held("audio.compute_fbank_matrix", lambda d: PAu.compute_fbank_matrix(
        16000, 512, 40, device=d))
    held("audio.create_dct", lambda d: PAu.create_dct(13, 40, device=d))
    held("audio.power_to_db", lambda d: PAu.power_to_db(sg(d).abs() ** 2))
    for layer, kw in (("Spectrogram", dict(n_fft=128)),
                      ("MelSpectrogram", dict(sr=16000, n_fft=128,
                                              n_mels=16)),
                      ("LogMelSpectrogram", dict(sr=16000, n_fft=128,
                                                 n_mels=16)),
                      ("MFCC", dict(sr=16000, n_mfcc=8, n_mels=16,
                                    n_fft=128))):
        held(f"audio.{layer}", lambda d, layer=layer, kw=kw: getattr(
            PAu, layer)(**kw, device=d)(sg(d)))

    def dense(r):
        return r.to_dense() if isinstance(r, PSp._SparseBase) else r
    for cid, fn in C.SPARSE_OPS:
        held(f"sparse.{cid}", lambda d, fn=fn: dense(fn(
            PSp, lambda a, d=d: torch.from_numpy(np.asarray(a)).to(d))))
    for cid in ("coo", "csr"):
        held(f"sparse.{cid}", lambda d, cid=cid: dense(getattr(C, cid)(
            PSp, lambda a, d=d: torch.from_numpy(np.asarray(a)).to(d))))
    for name, dist, value in C.dists(PD, lambda a: torch.from_numpy(
            np.asarray(a))):
        for meth in ("log_prob", "prob", "entropy", "mean", "variance",
                     "cdf"):
            try:
                getattr(dist, meth)
            except (AttributeError, NotImplementedError):
                continue

            def call(d, name=name, meth=meth):
                dd, vv = next((x, v) for n, x, v in C.dists(
                    PD, lambda a: torch.from_numpy(np.asarray(a)).to(d))
                    if n == name)
                f = getattr(dd, meth)
                return f(vv) if meth in ("log_prob", "prob", "cdf") else \
                    (f() if meth == "entropy" else f)
            try:
                call("cpu")
            except NotImplementedError:
                continue
            held(f"distribution.{name}.{meth}", call)
    for cid, pair in C.KL_PAIRS:
        held(f"distribution.kl-{cid}", lambda d, pair=pair: PD.kl_divergence(
            *pair(PD, lambda a: torch.from_numpy(np.asarray(a)).to(d))))
    # the random ones, on the card: shape, dtype, support, moments
    gen = ptt.make_generator(seed + 157, dev)
    n = 200000
    draws = {
        "tensor.rand": (P.rand([n], generator=gen), 0.5, 1 / 12, (0, 1)),
        "tensor.randn": (P.randn([n], generator=gen), 0.0, 1.0, None),
        "tensor.normal": (P.normal(2.0, 3.0, [n], generator=gen), 2.0, 9.0,
                          None),
        "tensor.uniform": (P.uniform([n], min=-2.0, max=4.0, generator=gen),
                           1.0, 3.0, (-2, 4)),
        "tensor.randint": (P.randint(2, 7, [n], generator=gen).float(), 4.0,
                           2.0, (2, 6)),
        "tensor.bernoulli": (P.bernoulli(torch.full([n], 0.3, device=dev),
                                         generator=gen), 0.3, 0.21, (0, 1)),
        "tensor.poisson": (P.poisson(torch.full([n], 4.0, device=dev),
                                     generator=gen), 4.0, 4.0, (0, None)),
        "tensor.multinomial": (P.multinomial(torch.tensor(
            [[1., 0., 3.]], device=dev), n, replacement=True,
            generator=gen)[0].float(), 1.5, 0.75, (0, 2)),
        "distribution.Gamma": (PD.Gamma(torch.tensor(3.0, device=dev),
                                        torch.tensor(2.0, device=dev))
                               .sample((n,), generator=gen), 1.5, 0.75,
                               (0, None)),
        "distribution.Beta": (PD.Beta(torch.tensor(2.0, device=dev),
                                      torch.tensor(3.0, device=dev))
                              .sample((n,), generator=gen), 0.4, 0.04,
                              (0, 1)),
        "distribution.StudentT": (PD.StudentT(
            torch.tensor(6.0, device=dev)).sample((n,), generator=gen),
            0.0, 1.5, None),
        "distribution.Binomial": (PD.Binomial(
            torch.tensor(10.0, device=dev), torch.tensor(0.3, device=dev))
            .sample((n,), generator=gen), 3.0, 2.1, (0, 10)),
    }
    for name, (a, mean, var, support) in draws.items():
        a = a.double()
        if a.device.type != "cuda":
            bad.append(f"{name}: drawn on {a.device}")
        if abs(float(a.mean()) - mean) > 5 * (var / n) ** 0.5:
            bad.append(f"{name}: mean {float(a.mean())} (want {mean})")
        if support is not None and (
                float(a.min()) < support[0]
                or (support[1] is not None and float(a.max()) > support[1])):
            bad.append(f"{name}: outside {support}")
    perm = P.randperm(1000, generator=gen)
    if sorted(perm.tolist()) != list(range(1000)):
        bad.append("tensor.randperm: not a permutation")
    over = {k: e for k, e in worst.items() if not e <= TOL_TENSOR_SWEEP}
    top = max(worst, key=worst.get)
    log(f"[tensor] (d) the sweep: {len(worst)} calls of tensor, linalg "
        f"(lstsq and the reconstructions on the card), fft, signal (stft / "
        f"istft of a [2, 40] signal at n_fft 128 included), audio, sparse "
        f"and distribution held on the card against the CPU in fp32, "
        f"worst relative error {worst[top]:.3g} ({top}; tol "
        f"{TOL_TENSOR_SWEEP}); {len(draws) + 1} random ones on the card "
        f"by support and moments over {n} draws: "
        f"{'held' if not bad else f'{len(bad)} failed'} [{card}]")
    if over or bad:
        fail(f"tensor (d): over tolerance {over}; {len(bad)} failed, the "
             f"first {bad[:20]}")
    return len(worst), worst[top]


def phase_tensor(seed, dev, card):
    """The tensor-level API on the card (``[tensor]`` lines): (a) the JAX
    training idiom at Llama-3-8B's widths through the flash kernels; (b)
    ``vmap`` through the kernel, one launch; (c) a ``PyLayer``; (d) the
    sweep. Returns the main-path launches of (a) and (b)."""
    t0 = time.perf_counter()
    a_launches, a_times = _tensor_functional(seed, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    b_launches = _tensor_vmap(seed, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    _tensor_pylayer(seed, dev, card)
    _tensor_sweep(seed, dev, card)
    launches = {k: a_launches[k] + b_launches[k] for k in a_launches}
    log(f"[tensor] the phase took {time.perf_counter() - t0:.1f} s; "
        f"launches of its main-path runs {launches} [{card}]")
    return launches


def _clock_phases():
    """Make every ``phase_*`` function of this module log its wall time
    when it returns (``[wall]`` lines): the script's time limit is shared
    by all of them."""
    g = globals()
    for name in [n for n in g if n.startswith("phase_")]:
        def timed(*a, _fn=g[name], _name=name, **kw):
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            log(f"[wall] {_name} {time.perf_counter() - t0:.1f} s")
            return out
        g[name] = timed


def main():
    t_start = time.perf_counter()
    _clock_phases()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "card")
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import paddle_tpu_torch ({e}); run from the root of "
             f"the repository")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[card] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    phase_build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    errs = phase_kernel_checks(gen, dev)
    errs["ragged"] = phase_ragged_checks(gen, dev)
    errs["grid"] = phase_grid_checks(gen, dev)
    errs["quant"] = phase_quant_checks(gen, dev)
    phase_bwd_checks(gen, dev)
    phase_fp16_checks(gen, dev)
    errs["fused_adamw"] = phase_adam_checks(gen, dev)
    times = phase_kernel_times(gen, dev, card)
    times.update(phase_paged_time(gen, dev, card))
    phase_spec_ragged_time(gen, dev, card)
    times["quant"] = phase_quant_times(gen, dev, card)
    bwd_times, bwd_errs = phase_bwd_times(gen, dev, card)
    times.update(bwd_times)
    errs.update(bwd_errs)
    times["fused_adamw"] = phase_adam_times(args.seed, dev, card)
    phase_small_reference(dev)
    phase_small_quant(dev)
    phase_train_small(dev)
    bf16, model = phase_slice(args.seed, dev, card)
    launches = dict(bf16["launches"])
    routes = dict(bf16["routes"])
    paged, paged_routes = phase_paged(args.seed, dev, card, model)
    phase_spec(args.seed, dev, card, model)
    gw_launches, _, gw_dir = phase_gateway(args.seed, dev, card, model)
    phase_generate_family(args.seed, dev, card, model)
    host_launches = phase_host(args.seed, dev, card, model, gw_dir)
    launches["ragged"] = paged["ragged"] + gw_launches["ragged"]
    routes["ragged"] = paged_routes["ragged"]
    pred, int8 = phase_quant_slice(dev, card, model, bf16)
    launches["quant"] = int8["launches"]["quant"]
    routes["quant"] = int8["routes"]["quant"]
    grid_launches, grid_routes = phase_quant_paged(args.seed, dev, card,
                                                   pred.model)
    launches["grid"] = grid_launches["grid"]
    routes["grid"] = grid_routes["grid"]
    del pred, model, int8
    gc.collect()
    torch.cuda.empty_cache()
    pred4 = phase_int4(args.seed, dev, card, bf16)
    phase_decode_ab(args.seed, dev, card, pred4, bf16["ids"])
    del pred4, bf16
    gc.collect()
    torch.cuda.empty_cache()
    trained, train_routes = phase_train(args.seed, dev, card)
    for key in ("flash_bwd_dq", "flash_bwd_dkv", "fused_adamw"):
        launches[key] = trained[key]
        routes[key] = train_routes[key]
    phase_resume(args.seed, dev, card)
    phase_fp16_train(args.seed, dev, card)
    moe_launches, moe_plain = phase_moe(args.seed, dev, card)
    for key, n in moe_launches.items():
        launches[key] += n
    gc.collect()
    torch.cuda.empty_cache()
    errs["flash_lse"], times["flash_lse"], ring_launches, ring_routes = \
        phase_parallel(args.seed, gen, dev, card)
    launches["flash_lse"] = ring_launches["flash_lse"]
    routes["flash_lse"] = ring_routes["flash_lse"]
    gc.collect()
    torch.cuda.empty_cache()
    for key, n in phase_pp_ep(args.seed, dev, card).items():
        if key in ("flash", "flash_bwd_dq", "flash_bwd_dkv", "fused_adamw"):
            launches[key] += n
    gc.collect()
    torch.cuda.empty_cache()
    launches["ragged"] += phase_fleet(args.seed, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    for key, n in phase_tp(args.seed, gen, dev, card).items():
        launches[key] += n
    gc.collect()
    torch.cuda.empty_cache()
    for key, n in phase_tp_serve(args.seed, dev, card).items():
        launches[key] += n
    gc.collect()
    torch.cuda.empty_cache()
    for key, n in phase_tp_moe(args.seed, gen, dev, card, moe_plain).items():
        launches[key] += n
    gc.collect()
    torch.cuda.empty_cache()
    ft_launches, ft_errs = phase_finetune(args.seed, gen, dev, card)
    for key, n in ft_launches.items():
        launches[key] += n
    for key, err in ft_errs.items():
        errs[key] = max(errs[key], err)
    gc.collect()
    torch.cuda.empty_cache()
    zoo_launches, zoo_rows = phase_zoo(args.seed, gen, dev, card)
    for key, n in zoo_launches.items():
        launches[key] += n
    for _, key, r in zoo_rows:
        key = "quant" if key.startswith("quant") else key
        errs[key] = max(errs[key], r["err"])
    gc.collect()
    torch.cuda.empty_cache()
    for key, n in phase_vision(args.seed, dev, card).items():
        launches[key] += n
    gc.collect()
    torch.cuda.empty_cache()
    for key, n in phase_tp_zoo(args.seed, gen, dev, card).items():
        launches[key] += n
    for key, n in host_launches.items():
        launches[key] += n
    gc.collect()
    torch.cuda.empty_cache()
    for key, n in phase_api(args.seed, dev, card).items():
        launches[key] = launches.get(key, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    for key, n in phase_tensor(args.seed, dev, card).items():
        launches[key] = launches.get(key, 0) + n

    meta = {"flash": ("flash_attention_fwd", FLASH_SOURCE, FLASH_REPLACES),
            "flash_bwd_dq": ("flash_attention_bwd_dq", FLASH_BWD_SOURCE,
                             DQ_REPLACES),
            "flash_bwd_dkv": ("flash_attention_bwd_dkv", FLASH_BWD_SOURCE,
                              DKV_REPLACES),
            "decode": ("decode_attention", DECODE_SOURCE, DECODE_REPLACES),
            "ragged": ("ragged_paged_attention", RAGGED_SOURCE,
                       RAGGED_REPLACES),
            "grid": ("paged_attention", GRID_SOURCE, GRID_REPLACES),
            "quant": ("quant_matmul", QUANT_SOURCE, QUANT_REPLACES),
            "fused_adamw": ("fused_adamw", ADAM_SOURCE, ADAM_REPLACES),
            "flash_lse": ("flash_attention_with_lse",
                          f"{FLASH_SOURCE} + {FLASH_BWD_SOURCE}",
                          LSE_REPLACES)}
    kernels = []
    for key, (name, source, replaces) in meta.items():
        t = times[key]
        # the routed kernels: the routes their main-path launches took
        taken = [r for r, n in routes.get(key, {}).items() if n]
        route = "-".join(["cuda"] + taken)
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": errs[key], "ms": t["ms"],
                        "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    log(f"[wall] the script {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
