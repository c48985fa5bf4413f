"""Inference predictor (counterpart of ``paddle_tpu/inference.py``:
``Config``, ``Predictor`` with its ``run``, ``generate``,
``serve_stream`` and ``from_checkpoint``, ``BatchingPredictor`` and
``create_predictor``).

Requests pad their batch dim up to a fixed bucket ladder, with the last
row repeated, and the padding rows are cropped from every output, so
results are exact and a server sees few distinct batch shapes.
``serve_stream`` serves a request stream through a ``PagedEngine``.
``Config.enable_weight_only_quant(8 or 4)`` quantizes the model's
projections in place at load (``quant.quantize_model``), so every
decode-sized projection runs the fused dequant-matmul kernel.
``BatchingPredictor`` coalesces concurrent single requests into one
bucketed engine call on a collector thread, with the JAX package's
overload protection and its counters in the metrics registry.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import card_lock, resolve_device
from .utils import observability as obs
from .utils.faults import BackpressureError, RequestTimeoutError

__all__ = ["Config", "Predictor", "BatchingPredictor", "create_predictor",
           "BackpressureError", "RequestTimeoutError"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)

# per-process instance ids: every BatchingPredictor's counters live in
# the process registry under a unique engine label, so health() and a
# /metrics scrape read the same numbers
_batcher_ids = itertools.count()


class Config:
    """The predictor's settings: the checkpoint path, dtype, weight-only
    quantization and the batch bucket ladder."""

    def __init__(self, model_path: Optional[str] = None):
        self.model_path = model_path
        self.dtype = None                         # None = keep model dtype
        self.quant_bits: Optional[int] = None     # 8 / 4 / None
        self.quant_skip = ["lm_head", "embed"]
        self.batch_buckets: Optional[Tuple[int, ...]] = DEFAULT_BUCKETS

    def enable_weight_only_quant(self, bits: int = 8):
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        self.quant_bits = bits
        return self

    def set_dtype(self, dtype):
        """A torch dtype or its name ("bfloat16", "float32", ...)."""
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype, None)
        if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
            raise ValueError(f"not a floating dtype: {dtype!r}")
        self.dtype = dtype
        return self

    def set_batch_buckets(self, buckets: Optional[Sequence[int]]):
        """None disables bucketing (every batch runs at its own size)."""
        self.batch_buckets = tuple(sorted(buckets)) if buckets else None
        return self


def _pad_rows(x: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.cat([x, x[-1:].expand(cap - x.shape[0], *x.shape[1:])])


def _crop(out, b: int, cap: int):
    """Every tensor of ``out`` (nested tuples and lists too, as an MoE
    forward's (logits, aux)) with a leading dim of ``cap`` cut to ``b``
    rows."""
    if isinstance(out, (tuple, list)):
        return type(out)(_crop(o, b, cap) for o in out)
    if torch.is_tensor(out) and out.dim() and out.shape[0] == cap:
        return out[:b]
    return out


class Predictor:
    """Wraps a model for serving on ``device`` (the CUDA card unless the
    caller passes ``device="cpu"``; the model is moved there). As the JAX
    one does, it first casts the model's floating parameters to
    ``config.dtype`` (and gives the model a copy of its config in that
    dtype, so its KV caches and the engine's pools hold what its layers
    write) and then quantizes the model in place when
    ``config.quant_bits`` is set. To fuse the projections, call
    ``nn.fuse.fuse_projections(pred.model)`` after construction: the JAX
    order, cast, quantize, fuse.

    A model sharded on the caller's mesh (``parallel.sharding.
    shard_layer``, on the device the mesh's ranks run on) is served
    where it is: its parameters are cast as DTensors, its compute
    tensors bound once (``bind_static``), then each rank quantizes its
    own shards with the tp metadata."""

    def __init__(self, model, config: Optional[Config] = None, device=None):
        from .nn.common import copy_meta
        from .parallel.sharding import bind_static, is_sharded, map_local
        self.config = config or Config()
        self.device = resolve_device(device)
        sharded = any(is_sharded(p) for p in model.parameters())
        if self.config.dtype is not None:
            # parameters and persistent buffers (an MoE layer's
            # expert_bias), as the JAX package's Layer.to casts them; the
            # non-persistent fp32 RoPE frequencies keep their dtype. Each
            # parameter, plain or DTensor, becomes a new Parameter keeping
            # its partition; a tied one stays tied (the memo keeps the old
            # one alive, so its id is not reused)
            cast = {}
            for mod in model.modules():
                for name, p in mod._parameters.items():
                    if p is None or not p.is_floating_point():
                        continue
                    if id(p) not in cast:
                        # a DTensor's local tensor is cast and rewrapped
                        # in its placements (DTensor's own dispatch of
                        # the cast costs seconds a new shape on a mesh)
                        new = torch.nn.Parameter(
                            map_local(p.detach(),
                                      lambda t: t.to(self.config.dtype)),
                            requires_grad=p.requires_grad)
                        cast[id(p)] = (p, copy_meta(p, new))
                    mod._parameters[name] = cast[id(p)][1]
            for mod in model.modules():
                for name, buf in mod._buffers.items():
                    if buf is not None and buf.is_floating_point() and \
                            name not in mod._non_persistent_buffers_set:
                        mod._buffers[name] = buf.to(self.config.dtype)
            # the caches and pools the model allocates take the dtype its
            # layers now write (the JAX package keeps the config's and
            # promotes the attention; the port's kernels take one dtype)
            cfg = getattr(model, "config", None)
            if dataclasses.is_dataclass(cfg) and hasattr(cfg, "dtype"):
                model.config = dataclasses.replace(
                    cfg, dtype=self.config.dtype)
        if sharded:
            bind_static(model)
        if self.config.quant_bits:
            from .quant import quantize_model
            quantize_model(model, bits=self.config.quant_bits,
                           skip=self.config.quant_skip)
        # a sharded model already lives on its mesh's device
        self.model = (model if sharded else model.to(self.device)).eval()
        self.last_serve_stats = {}
        self.last_logprobs = {}
        self._paged_engines = {}

    def _bucket(self, b: int) -> int:
        for cap in self.config.batch_buckets or ():
            if b <= cap:
                return cap
        return b  # beyond the ladder (or no ladder): exact shape

    def _padded(self, x, b, cap):
        x = torch.as_tensor(x, device=self.device)
        if cap != b and x.dim() and x.shape[0] == b:
            return _pad_rows(x, cap)
        return x

    @torch.inference_mode()
    def run(self, *inputs):
        """Forward on host or device inputs; returns the model's outputs,
        with any batch padding cropped."""
        args = [torch.as_tensor(x, device=self.device) for x in inputs]
        b = args[0].shape[0] if args[0].dim() else 1
        cap = self._bucket(b)
        out = self.model(*[self._padded(a, b, cap) for a in args])
        return _crop(out, b, cap) if cap != b else out

    __call__ = run

    def generate(self, input_ids, prompt_start=None, **kwargs):
        """Autoregressive generation through the model's static KV cache
        (``generate`` of ``paddle_tpu_torch.generation``); the batch pads
        to its bucket and the padding rows are cropped. A model whose
        rows interact (``rows_independent`` False: MoE capacity is shared
        by every token of a call) runs at the caller's batch, as the JAX
        ``Predictor.generate`` runs every model: padding rows would
        change which of its tokens the experts drop."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        b = input_ids.shape[0]
        cap = self._bucket(b) \
            if getattr(self.model, "rows_independent", True) else b
        if prompt_start is not None:
            prompt_start = self._padded(prompt_start, b, cap)
        out = self.model.generate(self._padded(input_ids, b, cap),
                                  prompt_start=prompt_start, **kwargs)
        return out[:b]

    def serve_stream(self, requests, max_new_tokens: int = 64,
                     eos_token_id=None, sampling=None, **engine_kw):
        """Continuous-batching service for a mixed-length request stream:
        ``requests`` maps request_id -> input_ids. Admission is FIFO: a
        request enters the moment a slot and its blocks free up.
        ``sampling`` maps request_id -> dict of per-request overrides
        (temperature / top_k / top_p / seed / repetition_penalty /
        stop_sequences); chosen-token logprobs land in
        ``self.last_logprobs``. Returns request_id -> generated ids.

        ``engine_kw`` goes to ``PagedEngine``: its defaults are the
        device-resident tick (one CUDA-graph replay a tick on a card) with
        ring mode and delta transitions; ``fused_tick=False`` selects the
        host tick, and ``spec_tokens=k`` (with ``spec_ngram``) the
        speculative tick: up to k prompt-lookup drafts a row, verified in
        one forward and committed in the same program. The engine, its pools and captured tick programs
        included, is cached per ``engine_kw``, so repeated calls allocate
        nothing new."""
        from .generation.paged import PagedEngine
        key = tuple(sorted(engine_kw.items()))
        eng = self._paged_engines.get(key)
        if eng is None:
            eng = PagedEngine(self.model, **engine_kw)
            self._paged_engines[key] = eng
        for rid, ids in requests.items():
            eng.submit(rid, ids, max_new_tokens=max_new_tokens,
                       eos_token_id=eos_token_id,
                       **((sampling or {}).get(rid, {})))
        out = eng.run()
        eng.results.clear()  # the caller owns them now
        self.last_logprobs = dict(eng.logprobs)
        eng.logprobs.clear()
        self.last_serve_stats = dict(eng.stats)
        return out

    @classmethod
    def from_checkpoint(cls, model_factory: Callable[[], Any], path: str,
                        config: Optional[Config] = None, device=None):
        """Build the model, load its weights from a ``checkpoint.save``
        file in the JAX package's layout (``load_jax_state_dict``; one
        written by the JAX package's ``save(model.state_dict(), path)``
        or by ``save(convert.jax_state_dict(model), path)``), wrap it."""
        from .checkpoint import load
        from .convert import load_jax_state_dict
        model = model_factory()
        load_jax_state_dict(model, load(path))
        return cls(model, config, device=device)


class BatchingPredictor:
    """Server-side micro-batching over a Predictor (counterpart of the JAX
    package's ``BatchingPredictor``).

    Concurrent ``submit()`` calls enqueue single requests; a collector
    thread coalesces up to ``max_batch`` of them (waiting at most
    ``max_delay_ms`` once one is pending), stacks them into one bucketed
    engine call (``Predictor.run``) and resolves each request's Future
    with its own row. On a card the call runs under a share of
    ``card_lock``.

    Overload protection: ``max_queue`` bounds the admission queue, past
    which ``submit()`` raises ``BackpressureError`` at once; a request's
    ``timeout_s`` bounds its wait for dispatch (an expired request's
    Future fails with ``RequestTimeoutError``); Futures cancel while
    queued; ``close()`` drains by default. The counters live in the
    metrics registry under a unique ``engine=batcherN`` label, so
    ``health()`` reads the objects a scrape exports, and
    ``serving_queue_wait_ms`` records each admitted request's wait.
    """

    _STAT_KEYS = ("submitted", "served", "rejected", "timeouts",
                  "cancelled", "errors", "batches")

    def __init__(self, model, config: Optional[Config] = None,
                 max_batch: int = 8, max_delay_ms: float = 2.0,
                 max_queue: Optional[int] = None,
                 default_timeout_s: Optional[float] = None, device=None):
        self.predictor = Predictor(model, config, device=device)
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self.max_queue = max_queue
        self.default_timeout_s = default_timeout_s
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._aborting = False
        self._lock = threading.Lock()
        self._pending = 0
        labels = {"engine": f"batcher{next(_batcher_ids)}"}
        self._obs_labels = labels
        reg = obs.registry()
        self._stats = {k: reg.counter(f"serving_{k}_total", **labels)
                       for k in self._STAT_KEYS}
        self._g_queued = reg.gauge("serving_queue_depth", **labels)
        self._h_wait = reg.histogram("serving_queue_wait_ms", **labels)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, *inputs, timeout_s: Optional[float] = None) -> Future:
        """One request (no batch dim on the inputs) -> Future of its
        outputs (batch dim stripped). Raises ``BackpressureError`` when
        the admission queue is at ``max_queue``."""
        if self._closed:
            raise RuntimeError("BatchingPredictor is closed")
        timeout_s = timeout_s if timeout_s is not None \
            else self.default_timeout_s
        deadline = (time.monotonic() + timeout_s) \
            if timeout_s is not None else None
        # convert before claiming queue capacity: a bad input that raises
        # here must not leak a pending slot
        req = tuple(x.detach().cpu().numpy() if torch.is_tensor(x)
                    else np.asarray(x) for x in inputs)
        with self._lock:
            if self.max_queue is not None and \
                    self._pending >= self.max_queue:
                self._stats["rejected"].inc()
                obs.record_event("serve_reject",
                                 engine=self._obs_labels["engine"],
                                 pending=self._pending)
                raise BackpressureError(
                    f"admission queue at capacity ({self.max_queue} "
                    f"pending); shed load or retry with backoff")
            self._pending += 1
            self._g_queued.set(self._pending)
            self._stats["submitted"].inc()
        fut: Future = Future()
        self._q.put((req, fut, deadline, time.monotonic()))
        return fut

    def run(self, *inputs):
        return self.submit(*inputs).result()

    def health(self) -> dict:
        """Stats for load balancers and probes, read off the registry's
        counters (so they match a concurrent scrape)."""
        with self._lock:
            snap = {k: int(c.value) for k, c in self._stats.items()}
            snap["queued"] = self._pending
        snap.update(capacity=self.max_queue, max_batch=self.max_batch,
                    closed=self._closed,
                    worker_alive=self._worker.is_alive())
        return snap

    def _count(self, key: str):
        self._stats[key].inc()

    def _admit(self, item) -> bool:
        """Dequeue-side gate: False when the request must not enter a
        batch (cancelled, expired, or the predictor is aborting)."""
        _, fut, deadline, t_enq = item
        with self._lock:
            self._pending -= 1
            self._g_queued.set(self._pending)
        if self._aborting:
            fut.cancel()
            self._count("cancelled")
            return False
        if not fut.set_running_or_notify_cancel():
            self._count("cancelled")
            return False
        if deadline is not None and time.monotonic() > deadline:
            fut.set_exception(RequestTimeoutError(
                "request expired while queued for dispatch"))
            self._count("timeouts")
            return False
        # admitted requests only: an expired or cancelled one's wait says
        # nothing about dispatch latency
        self._h_wait.observe((time.monotonic() - t_enq) * 1e3)
        return True

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if not self._admit(item):
                continue
            batch = [item]
            deadline = time.monotonic() + self.max_delay
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    return
                if self._admit(nxt):
                    batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch):
        reqs = [r for r, _, _, _ in batch]
        futs = [f for _, f, _, _ in batch]
        self._count("batches")
        try:
            stacked = tuple(np.stack([r[i] for r in reqs])
                            for i in range(len(reqs[0])))
            if self.predictor.device.type == "cuda":
                with card_lock.shared():
                    out = self.predictor.run(*stacked)
            else:
                out = self.predictor.run(*stacked)
            for i, fut in enumerate(futs):
                fut.set_result(out[i] if torch.is_tensor(out) and out.dim()
                               else out)
                self._count("served")
        except Exception as e:  # the caller's Future carries it
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)
                    self._count("errors")

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting work. ``drain=True`` (default) serves every
        queued request before the collector stops (the join is unbounded
        unless ``timeout`` is given); ``drain=False`` fails queued
        requests at once (in-flight engine calls still finish)."""
        self._closed = True
        if not drain:
            self._aborting = True
        self._q.put(None)
        self._worker.join(timeout=timeout)
        # a submit() racing past the closed check may have enqueued after
        # the sentinel: its Future must fail, not hang
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            with self._lock:
                self._pending -= 1
                self._g_queued.set(self._pending)
            self._stats["cancelled"].inc()
            if not item[1].done():
                item[1].set_exception(
                    RuntimeError("BatchingPredictor closed before the "
                                 "request was served"))


def create_predictor(config: Config, model=None, device=None):
    """``paddle.inference.create_predictor``: the port, like the JAX
    package, needs the model object."""
    if model is None:
        raise ValueError("the predictor needs the model object (graph "
                         "serialization is not ported)")
    return Predictor(model, config, device=device)
