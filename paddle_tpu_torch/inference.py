"""Inference predictor (counterpart of ``paddle_tpu/inference.py``:
``Config`` and ``Predictor`` with its ``run``, ``generate`` and
``serve_stream``).

Requests pad their batch dim up to a fixed bucket ladder, with the last
row repeated, and the padding rows are cropped from every output, so
results are exact and a server sees few distinct batch shapes.
``serve_stream`` serves a request stream through a ``PagedEngine``.
``Config.enable_weight_only_quant(8 or 4)`` quantizes the model's
projections in place at load (``quant.quantize_model``), so every
decode-sized projection runs the fused dequant-matmul kernel.
``BatchingPredictor`` comes with a later slice of the port.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .device import resolve_device

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


class Config:
    """The predictor's settings: dtype, weight-only quantization and the
    batch bucket ladder."""

    def __init__(self):
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


class Predictor:
    """Wraps a model for serving on ``device`` (the CUDA card unless the
    caller passes ``device="cpu"``; the model is moved there). As the JAX
    one does, it first casts the model's floating parameters to
    ``config.dtype`` and then quantizes the model in place when
    ``config.quant_bits`` is set."""

    def __init__(self, model, config: Optional[Config] = None, device=None):
        self.config = config or Config()
        self.device = resolve_device(device)
        if self.config.dtype is not None:
            # parameters only: buffers such as the fp32 RoPE frequencies
            # keep their dtype
            for p in model.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(self.config.dtype)
        if self.config.quant_bits:
            from .quant import quantize_model
            quantize_model(model, bits=self.config.quant_bits,
                           skip=self.config.quant_skip)
        self.model = model.to(self.device).eval()
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
        if cap != b and out.dim() and out.shape[0] == cap:
            out = out[:b]
        return out

    __call__ = run

    def generate(self, input_ids, prompt_start=None, **kwargs):
        """Autoregressive generation through the model's static KV cache
        (``generate`` of ``paddle_tpu_torch.generation``); the batch pads
        to its bucket and the padding rows are cropped."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        b = input_ids.shape[0]
        cap = self._bucket(b)
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
