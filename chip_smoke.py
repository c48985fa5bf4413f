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
   16 share a 512-token prefix; prompts 520-900, 64-128 new), with the
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
   preempted at step 3 (``SystemExit(76)``, a ~17.8 GB checkpoint), a
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
   times beside SDPA and the bound; ERNIE-4.5-21B-A3B at full width and
   depth (``Ernie45MoeConfig()``, 21.77 B params, random bf16 weights
   drawn on the card) through ``Predictor.generate`` (4 x 512 + 64; the
   counts set to 0 just before the greedy run and read just after: flash
   28, decode 28 x 63 from a step graph of 28 decode nodes, all on their
   tensor-core routes; greedy and sampled bit for bit the uncaptured
   step; the stream teacher forced through the model's forward step by
   step; an MoE layer free of host reads under the sync-debug mode; the
   step against the bound of reading every expert's weights; the step's
   device time split into expert products, routing and dispatch,
   attention kernels and the rest), then through ``PagedEngine`` (16
   requests, whole-prompt prefill: ragged 28 x ticks inside the graphs,
   all mma; a profiled steady tick); DeepSeek-V2-Lite's published widths
   built through ``config_from_hf`` from a written ``config.json``,
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
   dequantized weight and the bound; (b) Llama-3-8B at full width and
   depth, twice from the seed: one plain, one sharded on a world-one
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

16. tensor-parallel serving behind the fleet (``[tp-serve]`` lines,
   last): (a) ``LocalProcessManager(tp=1)`` spawns ``replica_main --tp 1
   --model llama3-8b --seed`` through ``paddle_tpu_torch.distributed.
   launch`` (Llama-3-8B at full width and depth, built sharded on a
   world-one NCCL mesh and bound once, its engine behind the
   ``SequencedEngine`` that a tp replica's rank 0 serves: every call
   recorded, encoded, decoded and applied before each step, with no
   collective at tp 1) behind a ``FleetFrontend``; 8 greedy requests
   sharing a 384-token prefix and one sampled: every stream bit for bit a
   direct plain ``PagedEngine`` on this process's own model from the
   seed (tokens and logprobs). Read from the replica's ``/debugz`` over
   the traffic: ragged launches exactly 32 a decode tick, all on mma;
   flash launches 0 (the engine's prefill chunks attend through dense
   attention, as phase 11's counts show: flash serves ``generate()``);
   the sequencer's host microseconds a step (record, send, apply). Printed: client TTFT p50/p99 and new tokens/s. A
   SIGTERM drains the replica and every process of it exits 0. (b)
   ``from_pretrained`` of the 2-layer full-width Llama-3-8B checkpoint
   (phase 10 (e)'s) inside ``sharded_build`` on a world-one NCCL mesh:
   every parameter bit for bit the whole loader's, with each load's
   seconds and peak card memory. tp > 1 (the broadcast to other ranks, a
   follower's loss, a rank's slices of a checkpoint) is proved by the
   CPU gloo tests. The phase's ragged launches join the kernels line's.

It prints a JSON line of per-kernel numbers (each kernel's route taken
from its wrapper's counts on the main path: ``cuda-wgmma`` for the flash
forward, dq and dk/dv, ``cuda-mma`` for decode, ragged, quant and grid,
``cuda-simt`` for the fused AdamW update; ``flash_attention_with_lse``'s
launches are the ring's of phase 12),
then the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Without a CUDA
card, or without the ``paddle_tpu_torch`` package beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
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


def _gateway_traffic(rs, ids):
    """The gateway's and the fleet's 24 requests: 16 share a 512-token
    prefix, prompts of 520-900 tokens, 64-128 new, every third one JSON
    (not streamed), one in six sampled. ``rs``: a numpy RandomState;
    ``ids(n)``: n seeded token ids."""
    prefix = ids(512)
    reqs = []
    for i in range(24):
        n_new = int(rs.randint(64, 129))
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


def phase_gateway(seed, dev, card, model):
    """Llama-3-8B served over HTTP/SSE by the port's ``Gateway``: two
    replicas on the one model (graphed ticks, ring, tick profiler, prefix
    cache, a spill arena) against a direct engine; the tick-phase split
    of a plain and a speculative tick; ``/profilez``; the spill tier at
    full width; the drain. Returns the ragged launches and routes of the
    gateway's traffic."""
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

    # the run dir /profilez traces into; removed with its artifacts at
    # the end of the phase
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_gateway_")
    obs.configure(run_dir)
    geo = dict(PAGED, chunk_prefill_tokens=128, enable_prefix_cache=True)
    reqs = _gateway_traffic(rs, ids)
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
        f"16 share a 512-token prefix; prompts 520-900, 64-128 new): "
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
    obs.reset()
    shutil.rmtree(run_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[gateway] the phase took {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return launches, routes


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
            out = (FlashAttentionFunction.apply(*xs, True) if fn == "flash"
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
                       label="train step (4 layers, [2,2048])"):
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
        f"update kernel's {fused:.2f} ms (the per-tensor update before it: "
        f"{ADAM_BEFORE_MS} ms) [{card}]")
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
    of Llama-3-8B width, 4 layers, fp32 masters, AdamW, a clip scale):
    the kernel, its plain version (tensor by tensor) and
    ``torch.optim.AdamW(fused=True)`` stepping fp32 copies with their own
    fp32 gradients (the same 28 bytes a parameter), in turns (kernel,
    plain, library, library, plain, kernel), CUDA events over 3 calls a
    turn; beside the bound from this run's parameter count."""
    import numpy as np

    from paddle_tpu_torch.ops.kernels.fused_adam import (
        fused_adam, fused_adam_reference)
    model = _train_model(seed, dev)
    params = [p.detach() for p in model.parameters()]
    n = sum(p.numel() for p in params)
    gen = torch.Generator(device=dev).manual_seed(seed + 30)
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
    log(f"[adam] update of {n / 1e9:.3f} B parameters (Llama-3-8B width, "
        f"{TRAIN_LAYERS} layers, {len(params)} tensors, bf16 + fp32 masters,"
        f" AdamW, clip): kernel " + ", ".join(f"{x:.3f}" for x in
                                             times["kernel"])
        + " ms; plain " + ", ".join(f"{x:.3f}" for x in times["plain"])
        + " ms; torch.optim.AdamW(fused=True) on fp32 copies "
        + ", ".join(f"{x:.3f}" for x in times["library"])
        + f" ms; bound {bound_ms:.3f} ms ({bound_by}: {nbytes / 1e9:.2f} GB "
        f"at 3.35 TB/s) -> kernel at {100 * bound_ms / el['kernel']:.1f} % "
        f"of the bound; the per-tensor update before this kernel "
        f"{ADAM_BEFORE_MS} ms [{card}]")
    del model, params, grads, masters, ms, vs, lib, lib_params, cache
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
    free1 = shutil.disk_usage(root).free / 1e9
    stopped = tr.global_step
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[resume] Llama-3-8B width, {RESUME_LAYERS} layer(s) (depth cut "
        f"from 32 for the checkpoint's size on this machine's disk), "
        f"{n_params / 1e9:.3f} B params: preempt@{RESUME_PREEMPT} -> "
        f"SystemExit({code}) at step {stopped}; checkpoint of step "
        f"{RESUME_PREEMPT}: {gb:.2f} GB written, host copy "
        f"{save.get('snapshot_s', float('nan')):.2f} s + files, sha256 and "
        f"commit {save.get('write_s', float('nan')):.2f} s (the run "
        f"{preempt_s:.1f} s in all); free disk {free0:.1f} GB before, "
        f"{free1:.1f} GB after [{card}]")
    if code != PREEMPTED_RC or stopped != RESUME_PREEMPT or not gb:
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
# reads)
DSV2_LITE = {
    "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048,
    "intermediate_size": 10944, "moe_intermediate_size": 1408,
    "num_hidden_layers": 27, "num_attention_heads": 16,
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
# the MoE phase's depth cuts (none: every model at its published depth)
MOE_CUTS = "none"


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
    """ERNIE-4.5-21B-A3B at full width and depth, random bf16 weights
    drawn on the card: ``generate`` (graphed; against the uncaptured
    step; teacher forced), the decode step's split and bound, then the
    PagedEngine. Returns the launches of the main paths."""
    import numpy as np

    import paddle_tpu_torch as ptt
    t0 = time.perf_counter()
    cfg = ptt.models.Ernie45MoeConfig()
    model = ptt.models.Ernie45MoeForCausalLM(
        cfg, device=dev, generator=ptt.make_generator(seed + 60, dev))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    L = cfg.num_hidden_layers
    log(f"[moe] ERNIE-4.5-21B-A3B (Ernie45MoeConfig() defaults: {L} layers, "
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
    launches["ragged"] = _moe_engine(seed, dev, card, model)
    del pred, model, run
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _moe_engine(seed, dev, card, model):
    """The PagedEngine on ERNIE at its defaults (graphed ticks), whole-
    prompt prefill, 16 greedy requests: ragged once per layer and tick on
    the mma route, never in a prefill; a steady tick profiled."""
    import numpy as np

    from paddle_tpu_torch.generation.paged import PagedEngine
    cfg = model.config
    L = cfg.num_hidden_layers
    rs = np.random.RandomState(seed + 62)
    gen = torch.Generator().manual_seed(seed + 63)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen)

    subs = [(f"m{i}", ids(int(rs.randint(64, 513))),
             dict(max_new_tokens=64)) for i in range(16)]
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
    del eng
    return launches["ragged"]


def _moe_deepseek(seed, dev, card):
    """DeepSeek-V2-Lite's widths through ``config_from_hf`` and
    ``generate`` (graphed; MLA reaches no kernel of the port), then the
    V3-style variant through ``mtp_speculative_generate``."""
    import dataclasses

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.generation import eager_steps
    from paddle_tpu_torch.generation.speculative import \
        mtp_speculative_generate
    from paddle_tpu_torch.models.hf_interop import config_from_hf
    b, prompt, new = 4, 512, 64

    def build(hf, seed_, **over):
        d = tempfile.mkdtemp(prefix="chip_smoke_dsv2_")
        try:
            with open(os.path.join(d, "config.json"), "w") as f:
                json.dump(hf, f)
            cls, cfg, mt = config_from_hf(d)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        cfg = dataclasses.replace(cfg, **over)
        t0 = time.perf_counter()
        model = cls(cfg, device=dev,
                    generator=ptt.make_generator(seed_, dev))
        torch.cuda.synchronize()
        return model, cfg, mt, time.perf_counter() - t0

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
    del model, out
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe(seed, dev, card):
    """The MoE families (``[moe]`` lines): the kernels at ERNIE's shapes,
    ERNIE-4.5-21B-A3B through ``generate`` and the PagedEngine,
    DeepSeek-V2-Lite's widths through ``generate``, the V3-style variant
    through ``mtp_speculative_generate``. Returns the main paths'
    launches of flash, decode and ragged."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 50)
    _moe_kernel_checks(gen, dev, card)
    launches = _moe_ernie(seed, dev, card)
    _moe_deepseek(seed, dev, card)
    log(f"[moe] phase {time.perf_counter() - t0:.1f} s")
    return launches


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


def _tp_attention(gen, dev, card):
    """(a) The flash forward, decode and ragged kernels (T = 1 and 5) at
    every per-rank head count of ``TP_HEADS``, bf16, against their plain
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
    for label, (h, kvh) in TP_HEADS.items():
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
        log(f"[tp] (a) {label}: {h} query heads over {kvh} kv heads a rank, "
            f"bf16, max_abs_err against the plain versions "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (tol {TOL_BF16}); launches by route {got}")
        if got != want:
            fail(f"tp (a) {label}: launches by route {got} != {want}")
        if not all(e <= TOL_BF16 for e in errs.values()):
            fail(f"tp (a) {label}: a kernel disagrees with its plain "
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
            log(f"[tp] (a) time {key}, {label}, {r['shape']}: kernel "
                f"{r['ms']:.4f} ms (device time, CUDA graph), plain "
                f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
            rows.append((label, key, r))
    return rows


def _tp_quant(gen, dev, card):
    """(a) The quant kernel at Llama-3-70B's per-rank projections at tp 4
    (``TP_QUANT``), int8 and int4, m = 4 and 16: the row layers through
    the wrapper's ``block_offset`` into the whole scales table. Each
    against its plain version over the rank's scale blocks (``TOL_QUANT_*``),
    on the mma route by count; its device time beside the plain version,
    a bf16 matmul on the dequantized weight and the bound."""
    from paddle_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul, quant_matmul_plain)
    from paddle_tpu_torch.quant import dequantize_weight
    rows = []
    for bits in (8, 4):
        for label, din, dout, blocks, rank in TP_QUANT:
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
            for m in (4, 16):
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
                    fail(f"tp (a) quant {label}: not one mma launch")
                if bool(bad.any()):
                    fail(f"tp (a) quant int{bits} {label} m={m}: "
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
                log(f"[tp] (a) quant int{bits} {label} {din}->{dout} m={m}"
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
    """(b) Llama-3-8B at full width and depth on a world-one NCCL mesh
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
    cfg = ptt.llama3_8b()
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
    log(f"[tp] (b) Llama-3-8B at full width and depth twice from seed "
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
    cfg = ptt.llama3_8b()
    L = cfg.num_hidden_layers
    reqs = _tp_serve_requests(seed, cfg.vocab_size)
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_serve_")
    fe = FleetFrontend([], chunk_tokens=128, name="chip-tp-serve",
                       peer_read_timeout_s=FLEET_PEER_READ_TIMEOUT_S)
    mgr = LocalProcessManager(fe, model="llama3-8b", chunk_tokens=128,
                              seed=seed, tp=1,
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
        # the SIGTERM drain: the launcher passes it on, rank 0 drains
        t0 = time.perf_counter()
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
        log(f"[tp-serve] (a) replica_main --tp 1 --model llama3-8b --seed "
            f"{seed} through paddle_tpu_torch.distributed.launch (world-one "
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
        del direct, model
        return {"ragged": ragged}
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


def main():
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
    gw_launches, _ = phase_gateway(args.seed, dev, card, model)
    phase_generate_family(args.seed, dev, card, model)
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
    for key, n in phase_moe(args.seed, dev, card).items():
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
