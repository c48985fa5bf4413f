"""Trainer (counterpart of ``paddle_tpu/trainer.py``): the train loop with
gradient accumulation, the optimizer's clip and update, the logging
window (loss, steps/s, tokens/s, MFU), the NaN watchdog, callbacks, the
device prefetcher, and ``evaluate``, on one device.

The JAX package jits one step and folds accumulation into a ``lax.scan``;
PyTorch runs eagerly, so a step here is: for each microbatch, forward,
loss and ``torch.autograd.grad`` over the trainable parameters; the
gradients summed and divided by ``gradient_accumulation_steps``; then the
optimizer's ``apply`` (clip first), which updates the parameters in place.
Frozen parameters (``requires_grad=False``) get no gradient and no
optimizer state, as the JAX package's ``_trainable_keys`` does.

Machinery of the JAX trainer that belongs to the next training slice
raises ``NotImplementedError`` when the caller turns it on, and is never
skipped silently: checkpoint/resume (``save_steps > 0``), the preemption
exit (``graceful_shutdown=True``, the default: pass False), the hang exit
(``hang_timeout_s``), the compile cache (``compile_cache_dir``),
``aot_warmup``, the interleaved pipeline (``virtual_pp_degree > 1``) and
an enabled ``GradScaler``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from .io.device_prefetch import DevicePrefetcher, default_device_put
from .models.llama import causal_lm_loss
from .optimizer.optimizers import Optimizer
from .utils import observability as obs
from .utils.logging import LogWriter
from .utils.profiler import StepTimer, llama_flops_per_token
from .utils.watchdog import DivergenceError, StepWatchdog

# the exit code a preempted trainer returns (the JAX package's
# utils/shutdown.PREEMPTED_RC), kept so the arguments carry the same field
PREEMPTED_RC = 76

NEXT_SLICE = "the next training slice of the port"


@dataclass
class TrainingArguments:
    """The JAX package's ``TrainingArguments``: same fields, same
    defaults. The switches of the next training slice raise when set (see
    the module docstring). Fields that nothing here reads, kept so that
    arguments written for the JAX trainer construct unchanged:
    ``resume_from_checkpoint``, ``skip_data_on_resume`` and
    ``max_divergence_rollbacks`` (resume and rollback), ``hang_exit_code``
    and ``preempt_exit_code`` (the exits), all of the next slice;
    ``donate_state`` (XLA buffer donation: the update here is in place
    already); ``seed`` (the JAX trainer's per-step dropout key: the port's
    forward draws no random numbers until dropout is ported);
    ``max_grad_norm`` (the JAX trainer does not read it either:
    clipping is the optimizer's ``grad_clip``)."""
    output_dir: str = "output"
    max_steps: int = 1000
    gradient_accumulation_steps: int = 1
    logging_steps: int = 10
    save_steps: int = 0              # 0 = no periodic ckpt
    eval_steps: int = 0
    resume_from_checkpoint: bool = True
    max_grad_norm: float = 1.0
    seed: int = 42
    nan_patience: int = 3
    donate_state: bool = True
    hang_timeout_s: Optional[float] = None
    hang_exit_code: int = 17
    skip_data_on_resume: bool = True
    virtual_pp_degree: int = 1
    max_divergence_rollbacks: int = 2
    graceful_shutdown: bool = True
    preempt_exit_code: int = PREEMPTED_RC
    prefetch_depth: int = 2
    prefetch_stall_timeout_s: float = 5.0
    compile_cache_dir: Optional[str] = None
    aot_warmup: bool = False
    flops_per_token: float = 0.0


class TrainerCallback:
    def on_step_end(self, step: int, logs: Dict[str, float]):  # noqa: D401
        pass

    def on_save(self, step: int):
        pass

    def on_train_end(self, step: int):
        pass


class Trainer:
    """``loss_fn(model, batch) -> scalar`` replaces the default causal-LM
    loss on a batch of token ids [b, s]; ``logits_loss(logits, batch) ->
    scalar`` swaps only the loss head (the JAX package's ``loss_fn`` takes
    ``(pure_fn, params, batch)``; a torch module is its own function)."""

    def __init__(self, model: nn.Module, optimizer: Optimizer,
                 args: Optional[TrainingArguments] = None,
                 loss_fn: Optional[Callable] = None,
                 train_dataloader: Optional[Iterable] = None,
                 eval_dataloader: Optional[Iterable] = None,
                 callbacks: Optional[List[TrainerCallback]] = None,
                 scaler=None, logits_loss: Optional[Callable] = None):
        self.model = model
        self.optimizer = optimizer
        self.args = args or TrainingArguments()
        if loss_fn is not None and logits_loss is not None:
            raise ValueError("pass loss_fn OR logits_loss, not both")
        if scaler is not None and scaler.is_enable():
            raise NotImplementedError(
                f"fp16 loss scaling (GradScaler) comes with {NEXT_SLICE}; "
                f"train in bf16 or fp32")
        if loss_fn is not None:
            self.loss_fn = loss_fn
        elif logits_loss is not None:
            self.loss_fn = lambda m, batch: logits_loss(m(batch), batch)
        else:
            self.loss_fn = lambda m, batch: causal_lm_loss(m(batch), batch)
        self.train_dataloader = train_dataloader
        self.eval_dataloader = eval_dataloader
        self.callbacks = callbacks or []
        self._check_supported()
        self.logger = LogWriter(os.path.join(self.args.output_dir, "runs"))
        self.watchdog = StepWatchdog(nan_patience=self.args.nan_patience)
        params = dict(model.named_parameters())
        self._trainable = {k: p for k, p in params.items()
                           if p.requires_grad}
        self.device = next(iter(params.values())).device
        self._opt_state = None
        self.global_step = 0
        self._data_feed = None
        self.step_timer: Optional[StepTimer] = None
        self._derived_flops: Optional[float] = None

    def _check_supported(self):
        a = self.args
        off = {"save_steps > 0 (checkpoint/resume)": a.save_steps > 0,
               "graceful_shutdown=True (the preemption exit)":
                   a.graceful_shutdown,
               "hang_timeout_s (the hang exit)": a.hang_timeout_s is not None,
               "compile_cache_dir": a.compile_cache_dir is not None,
               "aot_warmup": a.aot_warmup,
               "virtual_pp_degree > 1 (the interleaved pipeline)":
                   a.virtual_pp_degree > 1}
        on = [k for k, v in off.items() if v]
        if on:
            raise NotImplementedError(
                f"{', '.join(on)}: comes with {NEXT_SLICE}; turn it off "
                f"(graceful_shutdown defaults to True: pass "
                f"graceful_shutdown=False)")

    # ---------------------------------------------------------------- step
    def _micro_batches(self, batch):
        accum = self.args.gradient_accumulation_steps
        if accum == 1:
            return [batch]
        if isinstance(batch, dict):
            return [{k: v[i] for k, v in batch.items()} for i in range(accum)]
        return [batch[i] for i in range(accum)]

    def _train_step(self, batch, stepno: int):
        """Forward, loss and gradients per microbatch, the mean of the
        gradients, then the optimizer's clip and in-place update. Returns
        the (mean) loss as a device scalar."""
        params = list(self._trainable.values())
        micro = self._micro_batches(batch)
        grads = None
        loss_sum = None
        for mb in micro:
            loss = self.loss_fn(self.model, mb)
            g = torch.autograd.grad(loss, params)
            loss = loss.detach()
            if grads is None:
                grads, loss_sum = list(g), loss
            else:
                torch._foreach_add_(grads, g)
                loss_sum = loss_sum + loss
            del g
        if len(micro) > 1:
            torch._foreach_div_(grads, len(micro))
            loss_sum = loss_sum / len(micro)
        with obs.span("optimizer_apply", step=stepno):
            self.optimizer.apply(self._trainable,
                                 dict(zip(self._trainable, grads)),
                                 self._opt_state, stepno)
        return loss_sum

    # --------------------------------------------------------------- train
    def train(self, max_steps: Optional[int] = None):
        args = self.args
        self._check_supported()
        max_steps = max_steps or args.max_steps
        obs.configure(os.path.join(args.output_dir, "runs"))
        obs.record_event("train_start", step=self.global_step,
                         max_steps=max_steps, run_id=obs.run_id(),
                         attempt=obs.attempt_id())
        if self._opt_state is None:
            self._opt_state = self.optimizer.init(self._trainable)
        if self.train_dataloader is None:
            raise ValueError("pass train_dataloader")
        feed = self.train_dataloader
        if args.prefetch_depth > 0:
            feed = DevicePrefetcher(
                self.train_dataloader, prep=self._prep_batch,
                depth=args.prefetch_depth,
                stall_timeout_s=args.prefetch_stall_timeout_s,
                device=self.device)
        self._data_feed = feed
        data = iter(feed)
        was_training = self.model.training
        self.model.train()
        try:
            return self._train_loop(data, max_steps)
        except BaseException as e:
            # crash postmortem: the last window of events hits disk before
            # the exception unwinds out of the trainer
            obs.record_event("crash", step=self.global_step, error=repr(e))
            obs.dump_flight(f"crash:{type(e).__name__}")
            raise
        finally:
            obs.flush()
            if feed is not self.train_dataloader:
                feed.close()
            self.model.train(was_training)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train_loop(self, data, max_steps: int):
        args = self.args
        prefetching = self._data_feed is not self.train_dataloader
        # windowed throughput meter: eval wall time is stopped out of the
        # window, so tokens_per_sec / mfu measure the step loop
        timer = self.step_timer = StepTimer(
            flops_per_token=args.flops_per_token)
        m_steps = obs.counter("train_steps_total")
        h_step = obs.histogram("train_step_wall_ms")
        win_tokens = 0
        win_steps = 0
        t_last = time.perf_counter()
        timer.start()
        while self.global_step < max_steps:
            t_step = time.perf_counter()
            try:
                batch = next(data)
            except StopIteration:
                data = iter(self._data_feed)
                try:
                    batch = next(data)
                except StopIteration:
                    raise ValueError("train_dataloader is empty") from None
            if not prefetching:
                batch = self._place(self._prep_batch(batch))
            if timer.flops_per_token == 0.0:
                if self._derived_flops is None:
                    self._derived_flops = self._derive_flops_per_token(batch)
                timer.flops_per_token = self._derived_flops
            stepno = self.global_step
            with obs.span("train_step", step=stepno):
                loss = self._train_step(batch, stepno)
            self.global_step += 1
            # host-side step wall (data wait + launch; the device runs
            # ahead and is amortized into the window by the logging sync)
            step_ms = (time.perf_counter() - t_step) * 1e3
            h_step.observe(step_ms)
            m_steps.inc()
            obs.record_event("step_end", step=stepno, ms=round(step_ms, 3))
            win_tokens += self._batch_tokens(batch)
            win_steps += 1
            self.watchdog.beat()
            if self.global_step % args.logging_steps == 0 or \
                    self.global_step == max_steps:
                loss_val = float(loss)   # host sync: closes the window
                try:
                    self.watchdog.check_loss(loss_val, self.global_step)
                except DivergenceError:
                    obs.record_event("divergence", step=self.global_step,
                                     loss=loss_val)
                    raise
                now = time.perf_counter()
                dt = timer.stop(win_tokens, win_steps)
                tps = win_tokens / max(dt, 1e-9)
                logs = {"loss": loss_val,
                        "steps_per_sec": win_steps / (now - t_last),
                        "tokens_per_sec": tps,
                        "mfu": timer.mfu_at(tps)}
                win_tokens = 0
                win_steps = 0
                t_last = now
                timer.start()
                self.logger.add_scalars(logs, self.global_step)
                for k, v in logs.items():
                    obs.gauge(f"train_{k}").set(v)
                obs.gauge("train_lr").set(self.optimizer.get_lr())
                obs.publish(self.logger, self.global_step)
                for cb in self.callbacks:
                    cb.on_step_end(self.global_step, logs)
            if args.eval_steps and self.eval_dataloader is not None \
                    and self.global_step % args.eval_steps == 0:
                if win_steps:
                    self._sync()
                    timer.stop(win_tokens, win_steps)
                    win_tokens = 0
                    win_steps = 0
                self.evaluate()
                self.watchdog.beat()  # a long eval is not a hung step
                timer.start()
                t_last = time.perf_counter()
        for cb in self.callbacks:
            cb.on_train_end(self.global_step)
        return self

    def _prep_batch(self, batch):
        """Fold a batch's leading dim into [accum, b / accum, ...]."""
        accum = self.args.gradient_accumulation_steps
        if accum > 1:
            def fold(x):
                b = x.shape[0]
                if b % accum:
                    raise ValueError(f"batch {b} is not a multiple of "
                                     f"gradient_accumulation_steps {accum}")
                return x.reshape((accum, b // accum) + tuple(x.shape[1:]))
            if hasattr(batch, "shape"):
                batch = fold(batch)
            elif isinstance(batch, dict):  # SFT/DPO dict batches
                batch = {k: fold(v) for k, v in batch.items()}
        return batch

    def _place(self, batch):
        return default_device_put(batch, self.device)

    # ------------------------------------------------------- perf meters
    @staticmethod
    def _token_array(batch):
        """The token-id array of a batch ([b, s] or the accum-folded
        [accum, b, s]): dict batches by ``input_ids``, tuple batches by
        first element; None when the batch carries no shaped array."""
        x = batch
        if isinstance(x, dict):
            x = x.get("input_ids", next(iter(x.values())))
        elif isinstance(x, (list, tuple)) and x:
            x = x[0]
        return x if getattr(x, "shape", None) else None

    @classmethod
    def _batch_tokens(cls, batch) -> int:
        """Token count of a step's batch for the throughput log."""
        x = cls._token_array(batch)
        return int(np.prod(tuple(x.shape))) if x is not None else 0

    def _derive_flops_per_token(self, batch) -> float:
        """Per-token train FLOPs for the MFU log when args.flops_per_token
        is unset: 6N (without the input embedding, a gather) plus the
        attention term, from the model config; 0.0 when the config lacks
        the fields (mfu then logs as 0)."""
        cfg = getattr(self.model, "config", None)
        layers = getattr(cfg, "num_hidden_layers", None)
        hidden = getattr(cfg, "hidden_size", None)
        if not layers or not hidden:
            return 0.0
        x = self._token_array(batch)
        if x is None:
            return 0.0
        seq = int(x.shape[-1])
        n_params = sum(p.numel() for p in self.model.parameters())
        vocab = getattr(cfg, "vocab_size", None)
        if vocab:
            n_params -= vocab * hidden
        return llama_flops_per_token(n_params, layers, seq, hidden)

    # ---------------------------------------------------------------- eval
    def evaluate(self) -> float:
        if self.eval_dataloader is None:
            raise ValueError("pass eval_dataloader")
        losses = []
        was_training = self.model.training
        self.model.eval()
        try:
            with obs.span("evaluate", step=self.global_step), \
                    torch.no_grad():
                for batch in self.eval_dataloader:
                    # device scalars; one host sync at the end
                    losses.append(self.loss_fn(self.model,
                                               self._place(batch)).float())
                mean = (float(torch.stack(losses).mean()) if losses
                        else float("nan"))
        finally:
            self.model.train(was_training)
        self.logger.add_scalar("eval_loss", mean, self.global_step)
        obs.record_event("eval", step=self.global_step, loss=mean)
        return mean
