"""Trainer (counterpart of ``paddle_tpu/trainer.py``): the train loop with
gradient accumulation, fp16 loss scaling, the optimizer's clip and update,
the logging window (loss, steps/s, tokens/s, MFU), callbacks, the device
prefetcher and ``evaluate``, on one device; and the JAX trainer's
machinery for long runs: periodic checkpoints with auto-resume (the
sampler's cursor restored in O(1)), the preemption exit, the hang exit,
and bounded divergence rollback.

The JAX package jits one step and folds accumulation into a ``lax.scan``;
PyTorch runs eagerly, so a step here is: for each microbatch, forward,
loss (times the GradScaler's scale, with one) and ``torch.autograd.grad``
over the trainable parameters; the gradients summed and divided by
``gradient_accumulation_steps``; then the optimizer's ``apply``, which
updates the parameters in place (Adam and AdamW in one fused pass). With
a GradScaler the unscale, the non-finite check, the skip of a bad step
and the move of the scale all stay on the device, as in the JAX step.
Frozen parameters (``requires_grad=False``) get no gradient and no
optimizer state, as the JAX package's ``_trainable_keys`` does.

Checkpoints go through ``checkpoint.distributed_ckpt`` (one directory a
step under ``<output_dir>/checkpoints``, asynchronous writes, sha256
manifests); a resume copies the saved tensors into the live ones in
place. The meta sidecar has the JAX trainer's keys (step, topology,
sampler), and a resume under another data-parallel degree reconciles the
gradient accumulation as the JAX trainer does.

On a mesh (``fleet.init`` then ``fleet.distributed_model``: DTensor
parameters) every rank runs this loop on the same step. The loader's
batch is the global batch, as the JAX step's is, unless it comes from a
``DistributedBatchSampler`` split over the mesh's batch coordinate (its
defaults under a mesh): each microbatch's rows are split over dp x fsdp
(dp major) and, for a token array, its positions over sp. The default
causal-LM loss then sums this rank's cross entropy over the next-token
labels of its block (the last position of an sp block is labelled by the
next block's first token) and divides by the global label count (one
all-reduce), so the ranks' losses and gradients add up to the JAX
step's; a custom ``loss_fn`` / ``logits_loss`` sees this rank's block and
its value is averaged over the ranks that split the data. The parameter
gradients come back from autograd as DTensors summed over those ranks
(see ``parallel.sharding``), the clip takes logical norms, a
GradScaler's overflow check agrees on every rank, and the update runs on
the local shards. Every rank takes part in a checkpoint (rank 0 writes
it), and the ranks agree on a preemption at a logging boundary and exit
on the same step.

With pp > 1 on the mesh and a model that has ``pipeline_functional``,
the step is the JAX trainer's pipeline step: the gradient-accumulation
microbatches [M, b, s] (a [b, s] batch is one) go through the 1F1B
schedule of ``parallel.pipeline``, or the interleaved one when
``virtual_pp_degree > 1``; the loss head runs on the last stage (the
default causal-LM loss, or ``logits_loss``), and every rank gets the
whole flat gradient, so the optimizer and the checkpoint see the usual
parameters. Under ep each rank multiplies its own experts
(``parallel.moe``). Checkpoints hold whole tensors under flat names, so
a run saved on any mesh resumes on any other.

Still raising ``NotImplementedError``, never skipped silently: the
compile cache (``compile_cache_dir``) and ``aot_warmup``, which have no
counterpart in an eager step yet.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from .distributed import env as denv
from .distributed.collective import _reduce_
from .io.device_prefetch import DevicePrefetcher, default_device_put
from .nn import functional as F
from .nn.norm import running_stats_kept
from .optimizer.optimizers import Optimizer
from .parallel import sharding
from .parallel.pipeline import pipeline_grads
from .utils import faults
from .utils import observability as obs
from .utils.logging import LogWriter
from .utils.profiler import StepTimer, llama_flops_per_token
from .utils.shutdown import PREEMPTED_RC, GracefulShutdown
from .utils.watchdog import DivergenceError, StepWatchdog

NEXT_SLICE = "a later slice of the port"


@dataclass
class TrainingArguments:
    """The JAX package's ``TrainingArguments``: same fields, same
    defaults, same meaning. ``compile_cache_dir`` and ``aot_warmup``
    raise when set (see the module docstring).
    Fields that nothing here reads, kept so that arguments written for the
    JAX trainer construct unchanged: ``donate_state`` (XLA buffer
    donation: the update here is in place already, and a checkpoint
    copies to the host before the next step); ``seed`` (the JAX trainer's
    per-step dropout key: the port's forward draws no random numbers
    until dropout is ported); ``max_grad_norm`` (the JAX trainer does not
    read it either: clipping is the optimizer's ``grad_clip``)."""
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
        # the pipeline step can only take a loss head (logits_loss): a
        # whole-model loss_fn cannot be split onto the stages
        self._default_loss = loss_fn is None
        self._logits_loss = logits_loss
        if loss_fn is not None:
            self.loss_fn = loss_fn
        elif logits_loss is not None:
            self.loss_fn = lambda m, batch: logits_loss(m(batch), batch)
        else:
            # the default causal-LM loss splits its labels itself: _loss
            self.loss_fn = None
        self.train_dataloader = train_dataloader
        self.eval_dataloader = eval_dataloader
        self.callbacks = callbacks or []
        self._check_supported()
        self.logger = LogWriter(os.path.join(self.args.output_dir, "runs"))
        self.watchdog = StepWatchdog(
            nan_patience=self.args.nan_patience,
            hang_timeout_s=self.args.hang_timeout_s,
            on_hang=self._on_hang if self.args.hang_timeout_s else None)
        params = dict(model.named_parameters())
        self._trainable = {k: p for k, p in params.items()
                           if p.requires_grad}
        self.device = sharding.local(next(iter(params.values()))).device
        self._opt_state = None
        # fp16 loss scaling: the scaler's state lives on the device and
        # moves inside the step; inf steps skip the update there
        self.scaler = scaler if (scaler is not None and scaler.is_enable()) \
            else None
        self._scaler_state = (self.scaler.init_state(self.device)
                              if self.scaler else None)
        self.global_step = 0
        self._rollbacks = 0
        self._in_recovery = False
        self._shutdown: Optional[GracefulShutdown] = None
        self._sampler_restored = False
        self._ckpt = None
        # the live feed of the current (or last) train(): the raw loader
        # or the DevicePrefetcher over it; checkpoint meta reads the
        # sampler position from HERE (the consumer position), never from
        # a loader the prefetcher has run ahead on
        self._data_feed = None
        self.step_timer: Optional[StepTimer] = None
        self._derived_flops: Optional[float] = None
        self._pipeline = None

    def _check_supported(self):
        a = self.args
        off = {"compile_cache_dir (the compile cache)":
                   a.compile_cache_dir is not None,
               "aot_warmup": a.aot_warmup}
        on = [k for k, v in off.items() if v]
        if on:
            raise NotImplementedError(
                f"{', '.join(on)}: comes with {NEXT_SLICE}; turn it off")

    # ---------------------------------------------------------------- step
    def _micro_batches(self, batch):
        accum = self.args.gradient_accumulation_steps
        if accum == 1:
            return [batch]
        if isinstance(batch, dict):
            return [{k: v[i] for k, v in batch.items()} for i in range(accum)]
        return [batch[i] for i in range(accum)]

    # ------------------------------------------------------------ the mesh
    @staticmethod
    def _split_degree() -> int:
        """How many ranks split the data: dp x fsdp x sp (1 off a mesh)."""
        return denv.axis_degree(sharding.GRAD_SUM_AXES)

    def _rows_split_by_sampler(self, loader) -> bool:
        """The loader yields this rank's rows already: its batch sampler
        is a DistributedBatchSampler over the mesh's batch coordinate."""
        from .io.sampler import DistributedBatchSampler
        bs = getattr(loader, "batch_sampler", None)
        deg, coord = denv.batch_coordinates()
        return (isinstance(bs, DistributedBatchSampler) and deg > 1
                and bs.nranks == deg and bs.local_rank == coord)

    def _local_batch(self, batch, loader):
        """This rank's block of a (global) microbatch: its rows over dp x
        fsdp, then, for arrays of two or more dims, its positions over
        sp. Dicts and tuples are split leaf by leaf."""
        deg, coord = denv.batch_coordinates()
        sp, sp_idx = denv.axis_degree("sp"), denv.axis_coordinate("sp")
        rows = deg > 1 and not self._rows_split_by_sampler(loader)

        def split(x):
            if not torch.is_tensor(x):
                return x
            if rows:
                if x.shape[0] % deg:
                    raise ValueError(f"batch rows {x.shape[0]} do not split "
                                     f"over dp x fsdp = {deg}")
                x = x.chunk(deg, dim=0)[coord]
            if sp > 1 and x.dim() >= 2:
                if x.shape[1] % sp:
                    raise ValueError(f"sequence {x.shape[1]} does not split "
                                     f"over sp = {sp}")
                x = x.chunk(sp, dim=1)[sp_idx]
            return x
        if isinstance(batch, dict):
            return {k: split(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(split(v) for v in batch)
        return split(batch)

    def _loss(self, batch, loader):
        """This rank's share of the loss of ``batch``, such that the
        ranks' shares add up to the loss of the global batch (the loss
        itself when no rank splits the data).

        The default loss is the shifted next-token cross entropy of
        ``causal_lm_loss`` in one form for every mesh: the labels are
        taken from the whole rows before the split (the last position of
        an sp block is labelled by the next one's first token), and this
        rank's summed cross entropy is divided by the global label count
        (an all-reduce, the identity off a mesh)."""
        if self.loss_fn is None:
            labels = torch.cat([batch[:, 1:], torch.full_like(
                batch[:, :1], -100)], dim=1)
            ids, labels = self._local_batch((batch, labels), loader)
            total = F.cross_entropy(self.model(ids), labels,
                                    ignore_index=-100, reduction="sum")
            count = (labels != -100).sum().to(total.dtype)
            count = _reduce_(count, "sum", sharding.GRAD_SUM_AXES)
            return total / count.clamp_min(1.0)
        n = self._split_degree()
        if n == 1:
            return self.loss_fn(self.model, batch)
        return self.loss_fn(self.model,
                            self._local_batch(batch, loader)) / n

    def _preempt_agreed(self, flag: bool) -> bool:
        """Whether to exit for a preemption now: ``flag`` itself on one
        rank; on several, ``flag`` or'ed over the world, and only at a
        logging boundary, where the loop has just synced the host with
        the device (the ranks exit on the same step, and a step between
        boundaries makes no host sync for it). A notice thus waits up to
        ``logging_steps`` steps on a world of more than one rank."""
        import torch.distributed as dist
        if not (dist.is_initialized() and dist.get_world_size() > 1):
            return flag
        if self.global_step % self.args.logging_steps:
            return False
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def _build_pipeline(self):
        """The pipeline step's ``vag(flat_params, tokens)`` when the mesh
        has pp > 1 and the model ``pipeline_functional`` (the JAX
        trainer's pp path, with its refusals), else None."""
        pp = denv.axis_degree("pp")
        if pp == 1 or not hasattr(self.model, "pipeline_functional"):
            return None
        if len(self._trainable) < len(dict(self.model.named_parameters())):
            raise ValueError(
                "frozen parameters (PEFT/LoRA) are not supported on "
                "the pipeline-parallel path: the 1F1B schedule "
                "differentiates the full stage stack; run LoRA under "
                "tp/fsdp/dp instead")
        if self.scaler is not None:
            raise ValueError("fp16 GradScaler is not supported with "
                             "pipeline parallelism (use bf16)")
        if not self._default_loss:
            raise ValueError(
                "a whole-model loss_fn cannot be decomposed onto "
                "pipeline stages; pass logits_loss=(logits, labels) -> "
                "scalar instead — it runs at the last stage")
        return self.model.pipeline_functional(
            pp, logits_loss=self._logits_loss,
            vpp=self.args.virtual_pp_degree)

    def _pipeline_step(self, batch, stepno: int):
        """One pipeline step: this rank's rows of each microbatch through
        the schedule, the whole flat gradient (on a sharded model the
        compute tensors' gradients taken back to the DTensor parameters
        in one backward, summed over the data axes there), then the
        optimizer. Returns the loss as a device scalar."""
        if not torch.is_tensor(batch):
            raise TypeError(
                "pipeline path expects a token-id array batch "
                f"[n_micro, b, s] or [b, s], got {type(batch)}")
        if batch.dim() == 2:  # [b, s] -> single microbatch
            batch = batch[None]
        tokens = torch.stack([self._local_batch(mb, self.train_dataloader)
                              for mb in batch])
        loss, grads = pipeline_grads(self.model, self._pipeline, tokens,
                                     self._trainable)
        with obs.span("optimizer_apply", step=stepno):
            self.optimizer.apply(self._trainable, grads, self._opt_state,
                                 stepno)
        return loss

    def _train_step(self, batch, stepno: int):
        """Forward, loss (scaled, with a GradScaler) and gradients per
        microbatch, the mean of the gradients, then the optimizer's clip
        and in-place update; with a GradScaler the unscale, the skip of a
        non-finite step and the move of the scale, all on the device.
        Returns the (mean, unscaled) loss as a device scalar."""
        if self._pipeline is not None:
            return self._pipeline_step(batch, stepno)
        params = list(self._trainable.values())
        micro = self._micro_batches(batch)
        scaler, sstate = self.scaler, self._scaler_state
        grads = None
        loss_sum = None
        for mb in micro:
            # the JAX step binds no buffers: BatchNorm's running statistics
            # stay where they are (nn/norm.py)
            with running_stats_kept():
                loss = self._loss(mb, self.train_dataloader)
            target = scaler.scale(loss, sstate) if scaler else loss
            # a parameter the loss does not reach (the pooler under an MLM
            # loss) gets a zero gradient, as jax.grad gives it
            g = torch.autograd.grad(target, params, materialize_grads=True)
            loss = loss.detach()
            if grads is None:
                grads, loss_sum = list(g), loss
            else:
                torch._foreach_add_([sharding.local(x) for x in grads],
                                    [sharding.local(x) for x in g])
                loss_sum = loss_sum + loss
            del g
        sharding.release(self.model)
        if len(micro) > 1:
            torch._foreach_div_([sharding.local(x) for x in grads],
                                len(micro))
            loss_sum = loss_sum / len(micro)
        if self._split_degree() > 1:
            loss_sum = _reduce_(loss_sum, "sum", sharding.GRAD_SUM_AXES)
        grads = dict(zip(self._trainable, grads))
        with obs.span("optimizer_apply", step=stepno):
            if scaler is None:
                self.optimizer.apply(self._trainable, grads,
                                     self._opt_state, stepno)
            else:
                inv = scaler.inv_scale(sstate)
                found_inf = scaler.found_inf(grads, inv)
                self.optimizer.apply(self._trainable, grads,
                                     self._opt_state, stepno,
                                     inv_scale=inv, found_inf=found_inf)
                self._scaler_state = scaler.update_state(sstate, found_inf)
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
        if args.resume_from_checkpoint and args.save_steps:
            self._try_resume()
        if self.train_dataloader is None:
            raise ValueError("pass train_dataloader")
        self._pipeline = self._build_pipeline()
        # the feed is built AFTER _try_resume restored the sampler's
        # position. Legacy fallback when no sampler state was restored
        # (plain iterables, checkpoints without meta): replay the stream
        # past the batches the restored steps consumed
        legacy_skip = bool(self.global_step and args.skip_data_on_resume
                           and not self._sampler_restored)
        feed = self.train_dataloader
        if args.prefetch_depth > 0:
            initial_iter = None
            if legacy_skip:
                # skip on the RAW loader: discarded batches must not pay
                # the fold and the copy in the producer thread
                initial_iter = self._skip_consumed(
                    iter(self.train_dataloader), self.global_step,
                    source=self.train_dataloader)
            feed = DevicePrefetcher(
                self.train_dataloader, prep=self._prep_batch,
                depth=args.prefetch_depth,
                stall_timeout_s=args.prefetch_stall_timeout_s,
                device=self.device, initial_iter=initial_iter)
        self._data_feed = feed
        data = iter(feed)
        if legacy_skip and feed is self.train_dataloader:
            data = self._skip_consumed(data, self.global_step)
        self._rollbacks = 0
        if self._shutdown is not None:
            # a latch tripped in an earlier train() call must not make
            # this one exit before its first step
            self._shutdown.clear()
        if args.graceful_shutdown:
            if self._shutdown is None:
                self._shutdown = GracefulShutdown()
            self._shutdown.install()
        was_training = self.model.training
        self.model.train()
        try:
            return self._train_loop(data, max_steps)
        except SystemExit:
            raise      # the preempt and hang exits dump their own record
        except BaseException as e:
            # crash postmortem: the last window of events hits disk before
            # the exception unwinds out of the trainer
            obs.record_event("crash", step=self.global_step, error=repr(e))
            obs.dump_flight(f"crash:{type(e).__name__}")
            raise
        finally:
            obs.flush()
            if feed is not self.train_dataloader:
                # the prefetcher keeps the consumer position, so a save
                # after train() still records the true sampler state
                feed.close()
            if self._shutdown is not None:
                self._shutdown.uninstall()
            self.model.train(was_training)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train_loop(self, data, max_steps: int):
        args = self.args
        prefetching = self._data_feed is not self.train_dataloader
        # windowed throughput meter: save and eval wall time is stopped
        # out of the window, so tokens_per_sec / mfu measure the step loop
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
            if faults.inject("preempt", step=self.global_step):
                # chaos: a scheduler's preemption notice (SIGTERM)
                # landing between steps
                sd = self._shutdown or GracefulShutdown()
                self._shutdown = sd
                sd.request("injected preempt")
            if self._preempt_agreed(self._shutdown is not None
                                    and self._shutdown.requested()):
                if self._shutdown is None:
                    self._shutdown = GracefulShutdown()
                self._shutdown.request("preempted on another rank")
                self._preempt_exit()
            if faults.inject("hang", step=self.global_step):
                # chaos: a stuck step; the watchdog's hang path must
                # checkpoint and exit
                time.sleep(faults.hang_seconds())
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
            if faults.inject("step_nan", step=self.global_step):
                # chaos: numeric divergence: NaN the float parameters (as
                # a NaN-gradient step would) and the reported loss, for
                # the watchdog and the rollback loop to recover from
                with torch.no_grad():
                    for p in self.model.parameters():
                        if p.is_floating_point():
                            sharding.local(p).mul_(float("nan"))
                loss = torch.full((), float("nan"))
            if self.global_step % args.logging_steps == 0 or \
                    self.global_step == max_steps:
                loss_val = float(loss)   # host sync: closes the window
                try:
                    self.watchdog.check_loss(loss_val, self.global_step)
                except DivergenceError:
                    obs.record_event("divergence", step=self.global_step,
                                     loss=loss_val)
                    if not self._maybe_rollback():
                        raise
                    # the restore's wall time is not step time
                    t_last = time.perf_counter()
                    timer.start()
                    win_tokens = 0
                    win_steps = 0
                    continue
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
            due_save = args.save_steps and \
                self.global_step % args.save_steps == 0
            due_eval = args.eval_steps and self.eval_dataloader is not None \
                and self.global_step % args.eval_steps == 0
            if due_save or due_eval:
                # close the throughput window before the save or eval
                # (drained, so the device's queue is not credited to it)
                if win_steps:
                    self._sync()
                    timer.stop(win_tokens, win_steps)
                    win_tokens = 0
                    win_steps = 0
                if due_save:
                    self.save_checkpoint()
                    self.watchdog.beat()  # a long save is not a hung step
                if due_eval:
                    self.evaluate()
                    self.watchdog.beat()  # ditto a long eval
                timer.start()
                t_last = time.perf_counter()
        for cb in self.callbacks:
            cb.on_train_end(self.global_step)
        if self._ckpt is not None:
            # a finished run's last checkpoint is durable on return
            self._ckpt.wait_until_finished()
        return self

    def _skip_consumed(self, data, n: int, source=None):
        """Advance the data iterator past ``n`` already-trained batches,
        re-iterating ``source`` (default: the live feed) at epoch
        boundaries."""
        if source is None:
            source = self._data_feed
        skip = n
        while skip > 0:
            got_any = False
            try:
                next(data)
                got_any = True
                skip -= 1
            except StopIteration:
                data = iter(source)
                try:
                    next(data)
                    skip -= 1
                except StopIteration:
                    if not got_any:
                        raise RuntimeError("train_dataloader is empty; "
                                           "cannot skip consumed batches")
        return data

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
                    loss = self._loss(self._place(batch),
                                      self.eval_dataloader).float()
                    if self._split_degree() > 1:
                        loss = _reduce_(loss, "sum",
                                        sharding.GRAD_SUM_AXES)
                    losses.append(loss)
                sharding.release(self.model)
                mean = (float(torch.stack(losses).mean()) if losses
                        else float("nan"))
        finally:
            self.model.train(was_training)
        self.logger.add_scalar("eval_loss", mean, self.global_step)
        obs.record_event("eval", step=self.global_step, loss=mean)
        return mean

    # --------------------------------------------------------- checkpoint
    def _ckpt_dir(self):
        return os.path.join(self.args.output_dir, "checkpoints")

    def _ckpt_manager(self):
        """ONE long-lived DistributedCheckpoint across the run, so the
        asynchronous write of a periodic save overlaps the next steps."""
        if self._ckpt is None:
            from .checkpoint.distributed_ckpt import DistributedCheckpoint
            self._ckpt = DistributedCheckpoint(self._ckpt_dir())
        return self._ckpt

    def _state_tree(self, scaler_state=None) -> Dict[str, Any]:
        tree = {"params": dict(self.model.named_parameters()),
                "opt_state": self._opt_state}
        if scaler_state is not None:
            tree["scaler"] = scaler_state
        return tree

    def save_checkpoint(self, wait: bool = False):
        """Checkpoint the current step: parameters, optimizer state and
        the GradScaler's state (copied to host memory before this
        returns), and the meta sidecar; written in the background unless
        ``wait``."""
        ckpt = self._ckpt_manager()
        with obs.span("checkpoint_save", step=self.global_step, wait=wait):
            ckpt.save(self.global_step, self._state_tree(self._scaler_state),
                      wait=wait, meta=self._checkpoint_meta())
        for cb in self.callbacks:
            cb.on_save(self.global_step)

    def _dp_degree(self) -> int:
        """Batch-sharding degree of the live mesh (dp and fsdp both split
        the batch; 1 with no mesh installed)."""
        return denv.axis_degree(denv.BATCH_AXES)

    def _live_mesh_shape(self) -> Optional[Dict[str, int]]:
        if not denv.has_mesh():
            return None
        return dict(denv.get_mesh().shape)

    def _loader_batch_size(self) -> Optional[int]:
        """The per-step batch the dataloader feeds, when discoverable
        (None for plain iterables)."""
        dl = self.train_dataloader
        bs = getattr(getattr(dl, "batch_sampler", None), "batch_size",
                     None) or getattr(dl, "batch_size", None)
        try:
            return int(bs) if bs else None
        except (TypeError, ValueError):
            return None

    def _checkpoint_meta(self) -> Dict[str, Any]:
        """Host-side sidecar for the step: the sampler position (O(1)
        resume) and the topology manifest (device count, dp degree,
        accumulation, mesh) for the cross-topology reconcile."""
        topo: Dict[str, Any] = {
            "device_count": denv.get_mesh().size if denv.has_mesh() else 1,
            "dp": self._dp_degree(),
            "accum": self.args.gradient_accumulation_steps}
        mesh_shape = self._live_mesh_shape()
        if mesh_shape is not None:
            topo["mesh"] = mesh_shape
        meta: Dict[str, Any] = {"step": self.global_step,
                                "topology": topo}
        # the live feed's state: with prefetch active the raw loader has
        # run AHEAD by the buffer depth; the prefetcher reports the
        # consumer position
        dl = self._data_feed if self._data_feed is not None \
            else self.train_dataloader
        if dl is not None and hasattr(dl, "state_dict"):
            try:
                sd = dl.state_dict()
                if sd:
                    meta["sampler"] = sd
            except Exception as e:  # sampler state is best-effort
                print(f"[trainer] sampler state_dict failed: {e}",
                      file=sys.stderr, flush=True)
        return meta

    def _preempt_exit(self):
        """Graceful-shutdown path: checkpoint the EXACT current step
        (sampler cursor included), durably, and exit with the preemption
        code the elastic supervisor restarts for free. SystemExit (not
        os._exit): the main thread is healthy here and unwinds."""
        reason = (self._shutdown.reason if self._shutdown else None) \
            or "requested"
        print(f"[trainer] preemption ({reason}) at global_step="
              f"{self.global_step}: checkpointing and exiting "
              f"rc={self.args.preempt_exit_code}",
              file=sys.stderr, flush=True)
        obs.record_event("preempt_exit", step=self.global_step,
                         reason=reason, rc=self.args.preempt_exit_code)
        try:
            self.save_checkpoint(wait=True)
        except Exception as e:
            # the grace window beats a perfect save: the latest periodic
            # checkpoint stands and the relaunch resumes from it
            print(f"[trainer] checkpoint during preemption failed: {e}; "
                  f"exiting anyway", file=sys.stderr, flush=True)
            obs.record_event("preempt_ckpt_failed", error=repr(e))
        obs.dump_flight("preempt")
        raise SystemExit(self.args.preempt_exit_code)

    def _on_hang(self):
        """Monitor-thread path for a hung step: best-effort checkpoint on
        a bounded side thread, then a hard exit (os._exit: the main thread
        is stuck and would never unwind) for the supervisor to relaunch."""
        print(f"[watchdog] step hung > {self.args.hang_timeout_s}s at "
              f"global_step={self.global_step}; checkpointing and exiting "
              f"rc={self.args.hang_exit_code}", file=sys.stderr, flush=True)
        obs.record_event("hang", step=self.global_step,
                         timeout_s=self.args.hang_timeout_s)
        obs.dump_flight("hang")
        if self._in_recovery:
            # wedged INSIDE a divergence rollback: the parameters are NaN,
            # and a snapshot now would poison every later auto-resume
            print("[watchdog] hang during divergence recovery; exiting "
                  "WITHOUT checkpointing (params are diverged)",
                  file=sys.stderr, flush=True)
            os._exit(self.args.hang_exit_code)

        def _save():
            try:
                self.save_checkpoint(wait=True)
            except Exception as e:
                print(f"[watchdog] checkpoint during hang failed: {e}",
                      file=sys.stderr, flush=True)

        t = threading.Thread(target=_save, daemon=True)
        t.start()
        t.join(timeout=max(30.0, 2 * self.args.hang_timeout_s))
        if t.is_alive():
            print("[watchdog] checkpoint did not finish in time; exiting "
                  "anyway (latest periodic checkpoint stands)",
                  file=sys.stderr, flush=True)
        os._exit(self.args.hang_exit_code)

    def _maybe_rollback(self) -> bool:
        """Bounded divergence recovery: reload the latest complete (and
        verified) checkpoint and go on. The data iterator is NOT rewound:
        the poisoned window (batches between the checkpoint and the
        divergence) is skipped, not replayed. False (the caller re-raises)
        when the rollbacks are used up or there is no checkpoint."""
        if self._rollbacks >= self.args.max_divergence_rollbacks:
            print(f"[trainer] divergence persists after {self._rollbacks} "
                  f"rollback(s); giving up", file=sys.stderr, flush=True)
            return False
        diverged_at = self.global_step
        # a long restore must not trip the hang path into saving NaN
        # parameters as the newest checkpoint
        self._in_recovery = True
        self.watchdog.beat()
        try:
            restored = self._try_resume(restore_data=False)
        finally:
            self._in_recovery = False
            self.watchdog.beat()
        if restored is None:
            print("[trainer] divergence with no complete checkpoint to "
                  "roll back to", file=sys.stderr, flush=True)
            return False
        self._rollbacks += 1
        self.watchdog.reset_nan()
        print(f"[trainer] divergence at step {diverged_at}: rolled back "
              f"to checkpoint step {restored} "
              f"(rollback {self._rollbacks}/"
              f"{self.args.max_divergence_rollbacks}); skipping the "
              f"poisoned data window", file=sys.stderr, flush=True)
        obs.counter("train_rollbacks_total").inc()
        obs.record_event("rollback", diverged_at=diverged_at,
                         restored_step=restored, rollback=self._rollbacks)
        obs.dump_flight("divergence_rollback")
        return True

    def _try_resume(self, restore_data: bool = True) -> Optional[int]:
        """Restore the latest complete checkpoint, if there is one, into
        the live parameters, optimizer state and scaler state (in place:
        the fused update's table stays valid); returns its step, or None.
        ``restore_data=False`` (divergence rollback) leaves the data
        iterator's position alone."""
        if not os.path.isdir(self._ckpt_dir()):
            return None
        ckpt = self._ckpt_manager()
        # a rollback can race an in-flight async save: make it durable
        # (its manifest written) before choosing the step; on a mesh the
        # other ranks wait for rank 0's write
        ckpt.wait_until_finished()
        denv.barrier()
        step = ckpt.latest_complete_step()
        if step is None:
            return None
        # the checkpoint may or may not hold scaler state (a run restarted
        # with or without fp16): try the matching tree first, then the
        # other, rather than abort the resume
        if self._scaler_state is not None:
            likes = [self._state_tree(self._scaler_state),
                     self._state_tree()]
        else:
            from .amp import GradScaler
            likes = [self._state_tree(),
                     self._state_tree(GradScaler().init_state(self.device))]
        restored, first_err = None, None
        for like in likes:
            try:
                restored = ckpt.restore(step, like=like)
                break
            except ValueError as e:
                first_err = first_err or e
        if restored is None:
            raise first_err
        # a saved scaler state without a live scaler is not restored
        _copy_into(self._state_tree(self._scaler_state), restored)
        # restore() may have fallen back past a corrupt latest step
        step = ckpt.last_restored_step
        self.global_step = step
        if restore_data:
            self._restore_meta(ckpt, step)
        return step

    def _restore_meta(self, ckpt, step: int):
        """Apply the step's sidecar: the O(1) sampler restore, instead of
        _skip_consumed's replay, and the reconcile of a checkpoint written
        under another data-parallel degree."""
        self._sampler_restored = False
        meta = ckpt.load_meta(step)
        if not meta:
            return
        self._reconcile_topology(meta.get("topology"))
        sd = meta.get("sampler")
        dl = self.train_dataloader
        if sd and dl is not None and hasattr(dl, "load_state_dict"):
            try:
                dl.load_state_dict(sd)
                self._sampler_restored = True
            except Exception as e:
                print(f"[trainer] sampler state restore failed ({e}); "
                      f"falling back to data replay",
                      file=sys.stderr, flush=True)


    def _reconcile_topology(self, saved: Optional[Dict[str, Any]]):
        """The job may come back with another data-parallel degree: keep
        the effective global batch by recomputing the gradient
        accumulation from the saved dp degree, and log the change, as the
        JAX trainer does. The parameters and moments are saved whole under
        their flat names, so they re-split onto any mesh, pipeline and
        expert parallel ones included."""
        if not saved:
            return
        cur_dp = self._dp_degree()
        old_dp = int(saved.get("dp", cur_dp) or cur_dp)
        if old_dp == cur_dp:
            return
        old_accum = int(saved.get("accum",
                                  self.args.gradient_accumulation_steps))
        effective = old_dp * old_accum
        new_accum = max(1, effective // cur_dp)
        # the accum factor must divide the loader batch (the step folds
        # the batch into accum microbatches): clamp down to a divisor
        batch = self._loader_batch_size()
        if batch:
            while batch % new_accum:
                new_accum -= 1
        if new_accum * cur_dp != effective:
            print(f"[trainer] effective global batch not exactly "
                  f"preservable: dp {old_dp}->{cur_dp} with accum "
                  f"{old_accum}, loader batch {batch} "
                  f"(using accum={new_accum})",
                  file=sys.stderr, flush=True)
        print(f"[trainer] topology change on resume: dp {old_dp} -> "
              f"{cur_dp} (mesh {saved.get('mesh')} -> now "
              f"{self._live_mesh_shape()}); gradient accumulation "
              f"{old_accum} -> {new_accum} to preserve the effective "
              f"global batch", file=sys.stderr, flush=True)
        self.args.gradient_accumulation_steps = new_accum


@torch.no_grad()
def _copy_into(live, saved):
    """Copy a restored tree's tensors into the live tree's, in place (a
    DTensor's restored leaf is this rank's shard already:
    ``DistributedCheckpoint.restore(like=...)`` reads only its pieces)."""
    if isinstance(live, dict):
        for k, v in live.items():
            _copy_into(v, saved[k])
    elif torch.is_tensor(live):
        sharding.local(live).copy_(saved)
