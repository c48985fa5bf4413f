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
   fp32, each call repeated bit for bit; the ragged paged kernel in bf16
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
   route. A second greedy call must give the same tokens, and one seeded
   sampled call must give valid ids. Last,
   torch.profiler splits one decode step's device time by kernel kind
   and gives the device's busy share of the step;
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
   the same losses.

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
   ``generate`` with quant 7 x 32 x 127 (all on the mma route), flash 32
   and decode 32 x 127 launches and its numbers next to bf16's;
   ``PagedEngine`` on it at its defaults (graphed ticks) under
   ``PADDLE_TPU_PAGED_ATTN=grid`` (grid once per layer and tick, all on
   the mma route, quant once per projection and tick or short prefill,
   ragged never, counted inside the graphs), the host tick's streams
   bit for bit, a rerun, a profiled steady tick (one graph launch, 32
   grid and 224 quant kernels, the grid attention's device time), and
   the same requests under ``ragged``; last the model rebuilt from the
   seed and quantized to int4, through the same ``generate``.

It prints a JSON line of per-kernel numbers (each kernel's route taken
from its wrapper's counts on the main path: ``cuda-wgmma`` for the flash
forward, dq and dk/dv, ``cuda-mma`` for decode, ragged, quant and grid),
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
import subprocess
import sys
import time

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
                             "flash_bwd_dkv", "quant", "grid"), 0)


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
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    b, h, d = q.shape
    T, kv = ck.shape[1], ck.shape[2]
    work, arrivals = da._scratch_for(q.device, b * kv * splits * (h // kv)
                                     * (d + 2), b * kv)
    out = torch.empty_like(q)
    fn = _build.entry("decode_attention",
                      f"decode_attention_fwd_{da.decode_route(q.dtype)}",
                      da._ARGTYPES)
    _build.check("decode_attention", fn(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), out.data_ptr(),
        work.data_ptr(), arrivals.data_ptr(), b, T, h, kv, d, ci, d ** -0.5,
        0, splits, da.DTYPES[q.dtype],
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


def phase_decode_checks(gen, dev):
    """The decode kernels (split along T; mma for bf16 and fp16, simt for
    fp32) against their plain version at the slice's shape (q [4,32,128],
    cache [4,640,8,128]) at cache indices on the edges of the splits, with
    and without a window; each call made twice must give the same bits.
    Returns the bf16 error at the last position."""
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
            if dtype == torch.bfloat16 and (ci, window) == (T - 1, None):
                main_err = err
        log(f"[check] decode {str(dtype)[6:]} ({decode_route(dtype)} "
            f"kernel) [4,32,128] over [4,640,8,128], "
            f"{splits} splits of {-(-T // splits)} positions: max_abs_err at "
            f"cache_index/window " + ", ".join(line) + f" (tol {tol}); "
            f"bitwise repeat")
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
        # wrapper's host time per call is longer than these kernels
        ms = graph_ms(lambda i: decode_attention_fwd(*sets[i % n], ci),
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
                               f"cache_index {ci} (CUDA graph; kernel "
                               f"{eager_ms:.4f} ms a call eager)")
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


def _generate_run(ptt, pred, ids, new, want, label, dev, card):
    """Warm-up, the prefill's own time (a generate of 1 token), then the
    main path: one greedy generate of ``new`` tokens with every kernel's
    count set to 0 just before and read just after (it must equal
    ``want``), and a second greedy call that must give the same tokens."""
    b, prompt = ids.shape
    vocab = pred.model.config.vocab_size
    greedy = ptt.GenerationConfig(max_new_tokens=new)
    one = ptt.GenerationConfig(max_new_tokens=1)
    pred.generate(ids, config=one)      # warm-up (cuBLAS handles, allocator)
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
    if tuple(out.shape) != (b, prompt + new):
        fail(f"{label}: generate returned shape {tuple(out.shape)}")
    if not torch.equal(out[:, :prompt], ids):
        fail(f"{label}: generate changed the prompt")
    if not ((out >= 0) & (out < vocab)).all():
        fail(f"{label}: generate returned ids outside the vocabulary")
    decode_ms = (total_ms - prefill_ms) / (new - 1)
    log(f"[{label}] prefill {prefill_ms:.1f} ms ({b} x {prompt} tokens + "
        f"first token), decode {decode_ms:.2f} ms/token step, "
        f"{b * new / (total_ms / 1e3):.1f} new tokens/s, generate "
        f"{total_ms:.1f} ms, peak memory {peak_gb:.2f} GB [{card}]")
    again = pred.generate(ids, config=greedy)
    if not torch.equal(again, out):
        fail(f"{label}: a second greedy generate gave other tokens")
    log(f"[{label}] second greedy generate: identical tokens")
    return dict(out=out, prefill_ms=prefill_ms, decode_ms=decode_ms,
                peak_gb=peak_gb, launches=launches, routes=routes)


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
    out = run["out"]
    sampled_cfg = ptt.GenerationConfig(max_new_tokens=new, do_sample=True,
                                       temperature=0.8, top_p=0.95)
    sampled = pred.generate(ids, config=sampled_cfg,
                            generator=ptt.make_generator(seed + 2, dev))
    ok = (tuple(sampled.shape) == (b, prompt + new)
          and bool(((sampled >= 0) & (sampled < cfg.vocab_size)).all())
          and torch.equal(sampled[:, :prompt], ids))
    if not ok:
        fail("sampled generate returned invalid ids")
    log(f"[slice] sampled generate (temperature 0.8, top_p 0.95): valid "
        f"ids; {int((sampled[:, prompt:] != out[:, prompt:]).sum())} of "
        f"{b * new} tokens differ from greedy")
    profile_decode_step(ptt, pred, ids, run["decode_ms"], card, "bf16")
    run.update(ids=ids, new=new, weight_gb=_weight_gb(model),
               logits=pred.run(ids)[:, -1].float())
    return run, model


def _reset_launches():
    from paddle_tpu_torch.ops.kernels.decode_attention import \
        decode_attention_fwd
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    from paddle_tpu_torch.ops.kernels.paged_attention import paged_attention
    from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention
    fns = {"flash": flash_attention_fwd, "decode": decode_attention_fwd,
           "ragged": ragged_paged_attention,
           "flash_bwd_dq": flash_attention_bwd_dq,
           "flash_bwd_dkv": flash_attention_bwd_dkv,
           "quant": quant_matmul, "grid": paged_attention}
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
        g = eng._graphs[steady]
        timed = _TimedGraph(g.graph)
        eng._graphs[steady] = g._replace(graph=timed)
    tick_ms = _timed_ticks(eng, ticks)
    if timed is not None:
        eng._graphs[steady] = g
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
            eng._weights_moved()
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
        names, memory = graph_nodes(eng._graphs[steady].graph)
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
        fail(f"{label}: the graphed tick's streams differ from the host "
             f"tick's: {bad}")


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

    import importlib.util

    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention

    # the stub's one definition, in the GPU tests (no JAX there), loaded by
    # its path: a ``tests`` package installed elsewhere may shadow ours
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_spec_gpu.py")
    spec = importlib.util.spec_from_file_location("test_torch_spec_gpu",
                                                  path)
    stubs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stubs)
    LookupStub = stubs.LookupStub

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
                                     "ragged"))].graph)
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
    1 and of 33 new tokens; the difference over 32 is one decode step.
    Device busy share = its device time over the step's wall time, with
    the profiler (inflated) and without it (``step_ms``, the main run);
    host idle = the unprofiled step less the device's busy time."""
    w1, c1, n1 = _device_profile(pred, ids, 1, ptt)
    w33, c33, n33 = _device_profile(pred, ids, 33, ptt)
    steps = 32
    if n33 == n1:
        log("[profile] torch.profiler recorded no device events: device "
            "busy share not measured")
        return
    step_wall = (w33 - w1) / steps
    per = {k: (c33[k] - c1[k]) / steps for k in c33}
    busy = sum(per.values())
    log(f"[profile] {label} decode step under the profiler: wall "
        f"{step_wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / step_wall:.1f} % of it, {100 * busy / step_ms:.1f}"
        f" % of the unprofiled {step_ms:.2f} ms step; host idle "
        f"{max(step_ms - busy, 0.0):.3f} ms of it), "
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
        timed(preds[key], 1)                           # warm
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
                                     max_steps=1, logging_steps=1,
                                     graceful_shutdown=False)
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


def _train_model(seed, dev, **overrides):
    import paddle_tpu_torch as ptt
    cfg = ptt.llama3_8b(num_hidden_layers=TRAIN_LAYERS, **overrides)
    return ptt.LlamaForCausalLM(cfg, device=dev,
                                generator=ptt.make_generator(seed, dev))


def _trainer(model, batches, steps, clock=None, prefetch_depth=2):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.optimizer import lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(3e-4, T_max=10),
                            warmup_steps=2)
    opt = ptt.optimizer.AdamW(
        learning_rate=sched, weight_decay=0.01, multi_precision=True,
        grad_clip=ptt.optimizer.ClipGradByGlobalNorm(1.0))
    args = ptt.TrainingArguments(output_dir="output/chip_smoke_train",
                                 max_steps=steps, logging_steps=1,
                                 prefetch_depth=prefetch_depth,
                                 graceful_shutdown=False)
    return ptt.Trainer(model, opt, args, train_dataloader=batches,
                       callbacks=[clock] if clock else None)


def profile_train_step(tr, step_ms, card):
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
        return
    busy = sum(cats.values())
    note = ("" if opt else " (no device-side optimizer range: the optimizer "
            "is not measured apart and is counted in other)")
    log(f"[profile] train step (4 layers, [2,2048]): under the profiler "
        f"{wall:.1f} ms, device busy {busy:.1f} ms ({100 * busy / step_ms:.1f}"
        f" % of the unprofiled median step {step_ms:.1f} ms), "
        f"{len(kernels)} device ops; "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in cats.items()) + note
        + f" [{card}]")


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
    want = dict(NO_LAUNCHES, flash=L * TRAIN_STEPS,
                flash_bwd_dq=L * TRAIN_STEPS, flash_bwd_dkv=L * TRAIN_STEPS)
    losses = [v for _, v in tr.logger.history["loss"]]
    log(f"[train] launches in {TRAIN_STEPS} steps: {launches} (want {want})")
    log(f"[train] losses per step: " + ", ".join(f"{x:.4f}" for x in losses))
    if launches != want:
        fail(f"training launches {launches} != {want}")
    routes = _check_routes("train", flash=L * TRAIN_STEPS,
                           flash_bwd_dq=L * TRAIN_STEPS,
                           flash_bwd_dkv=L * TRAIN_STEPS)
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
    # (depth 2, the default) or feed inline (depth 0), in the order 0, 2,
    # 2, 0; the median of each run's steps 3 to FEED_STEPS
    feed = {0: [], 2: []}
    for depth in (0, 2, 2, 0):
        clock = StepClock()
        tr = _trainer(model, batches, FEED_STEPS, clock, depth)
        torch.cuda.synchronize()
        clock.t = [time.perf_counter()]
        tr.train()
        torch.cuda.synchronize()
        feed[depth].append(float(np.median(np.diff(clock.t)[2:])) * 1e3)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[train] feed A/B, median step ms of steps 3-{FEED_STEPS} (host "
        f"clock, loss synced), runs in the order 0, 2, 2, 0: "
        f"prefetch_depth=0 " + ", ".join(f"{x:.2f}" for x in feed[0])
        + "; prefetch_depth=2 " + ", ".join(f"{x:.2f}" for x in feed[2])
        + f" [{card}]")
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
                   flash_bwd_dkv=L * 2)
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
    times = phase_kernel_times(gen, dev, card)
    times.update(phase_paged_time(gen, dev, card))
    phase_spec_ragged_time(gen, dev, card)
    times["quant"] = phase_quant_times(gen, dev, card)
    bwd_times, bwd_errs = phase_bwd_times(gen, dev, card)
    times.update(bwd_times)
    errs.update(bwd_errs)
    phase_small_reference(dev)
    phase_small_quant(dev)
    phase_train_small(dev)
    bf16, model = phase_slice(args.seed, dev, card)
    launches = dict(bf16["launches"])
    routes = dict(bf16["routes"])
    paged, paged_routes = phase_paged(args.seed, dev, card, model)
    phase_spec(args.seed, dev, card, model)
    launches["ragged"] = paged["ragged"]
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
    for key in ("flash_bwd_dq", "flash_bwd_dkv"):
        launches[key] = trained[key]
        routes[key] = train_routes[key]

    meta = {"flash": ("flash_attention_fwd", FLASH_SOURCE, FLASH_REPLACES),
            "flash_bwd_dq": ("flash_attention_bwd_dq", FLASH_BWD_SOURCE,
                             DQ_REPLACES),
            "flash_bwd_dkv": ("flash_attention_bwd_dkv", FLASH_BWD_SOURCE,
                              DKV_REPLACES),
            "decode": ("decode_attention", DECODE_SOURCE, DECODE_REPLACES),
            "ragged": ("ragged_paged_attention", RAGGED_SOURCE,
                       RAGGED_REPLACES),
            "grid": ("paged_attention", GRID_SOURCE, GRID_REPLACES),
            "quant": ("quant_matmul", QUANT_SOURCE, QUANT_REPLACES)}
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
