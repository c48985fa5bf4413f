"""LLM fine-tuning losses and trainers (counterpart of
``paddle_tpu/trl.py``; reference: PaddleNLP paddlenlp/trl, SFTTrainer and
DPOTrainer, and the llm/ alignment recipes).

Both recipes are ordinary Trainer steps; what this module adds is the
loss algebra and the batch conventions:

- SFT: causal-LM cross entropy masked to the RESPONSE tokens (prompt
  tokens give no gradient). Batches are dicts of fixed-shape tensors
  (``input_ids`` [b, s], ``loss_mask`` [b, s]), right-padded. Packed
  rows add ``segment_ids`` [b, s] and reach the model as ``positions=``
  and ``segment_ids=``: attention stays inside a segment (the flash
  kernels' segment route on the card) and RoPE restarts at each one.
- DPO: the Bradley-Terry preference loss on (chosen, rejected) pairs,
  with the reference log-probs computed beforehand
  (``compute_sequence_logps``) and carried in the batch, so the policy
  step holds no second model.

The loss closures take ``(model, batch)``, the port Trainer's
``loss_fn`` form (the JAX package's take ``(fn, params, batch)``).
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as TF

from .trainer import Trainer, TrainingArguments

__all__ = [
    "sft_loss", "sequence_logps", "compute_sequence_logps", "dpo_loss",
    "DataCollatorForSFT", "packed_sft_inputs", "SFTTrainer",
    "make_dpo_loss_fn", "DPOTrainer",
]


def _token_logps(logits, input_ids, loss_mask):
    """Shifted next-token log-probs at the masked positions: [b, s-1],
    fp32."""
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = lp.gather(-1, input_ids[:, 1:, None].long())[..., 0]
    return tgt * loss_mask[:, 1:].float()


def sft_loss(logits, input_ids, loss_mask, segment_ids=None):
    """Next-token cross entropy on the positions where loss_mask[t+1] ==
    1 (the response). With packed ``segment_ids``, a target whose context
    token lies in another segment is dropped: segment k's last token is
    never trained to predict segment k+1's first."""
    mask = loss_mask
    if segment_ids is not None:
        same = torch.cat(
            [torch.ones_like(segment_ids[:, :1], dtype=torch.bool),
             segment_ids[:, 1:] == segment_ids[:, :-1]], dim=1)
        mask = mask * same
    tok = _token_logps(logits, input_ids, mask)
    n = mask[:, 1:].sum().float().clamp_min(1.0)
    return -tok.sum() / n


def sequence_logps(logits, input_ids, loss_mask):
    """Per-sequence sum of the masked (response) tokens' log-probs."""
    return _token_logps(logits, input_ids, loss_mask).sum(dim=-1)


def _model_device(model) -> torch.device:
    from .parallel.sharding import local
    return local(next(iter(model.parameters()))).device


def compute_sequence_logps(model, input_ids, loss_mask, batch_size: int = 8):
    """Summed response log-probs of ``model`` over the sequences, in
    slices of ``batch_size`` rows: the DPO recipe's reference step. It
    runs in eval mode (dropout off: a reference in train mode would bias
    the log-probs with dropout noise) under ``torch.no_grad()`` and
    restores the mode after. Arrays that are not tensors move to the
    model's device."""
    dev = _model_device(model)
    input_ids = torch.as_tensor(input_ids, device=dev)
    loss_mask = torch.as_tensor(loss_mask, device=dev)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            outs = [sequence_logps(model(input_ids[i:i + batch_size]),
                                   input_ids[i:i + batch_size],
                                   loss_mask[i:i + batch_size])
                    for i in range(0, input_ids.shape[0], batch_size)]
    finally:
        model.train(was_training)
    return torch.cat(outs)


def dpo_loss(policy_chosen_logps, policy_rejected_logps,
             reference_chosen_logps, reference_rejected_logps,
             beta: float = 0.1, label_smoothing: float = 0.0):
    """Direct Preference Optimization (reference: PaddleNLP DPOTrainer;
    Rafailov et al. 2023). Returns (loss, chosen_rewards,
    rejected_rewards): the rewards are the implicit ones, for logging
    the margin and the accuracy."""
    chosen_rel = policy_chosen_logps - reference_chosen_logps
    rejected_rel = policy_rejected_logps - reference_rejected_logps
    logits = beta * (chosen_rel - rejected_rel)
    loss = (-TF.logsigmoid(logits) * (1 - label_smoothing)
            - TF.logsigmoid(-logits) * label_smoothing).mean()
    return loss, beta * chosen_rel, beta * rejected_rel


class DataCollatorForSFT:
    """prompt/response token lists -> right-padded fixed-shape batches
    {"input_ids": [b, max_len], "loss_mask": [b, max_len]} of int64 CPU
    tensors (reference: PaddleNLP llm/ SFT data pipeline).

    ``packing=True`` (reference: PaddleNLP's "intokens" / ZeroPadding
    packing) packs the examples first-fit into rows and adds
    ``segment_ids`` [b, max_len] int32 (0 = pad, 1..k = example):
    attention is then causal within a segment and positions restart at
    each example (``packed_sft_inputs``). ``pack_rows`` fixes the row
    count (empty rows pad it; more rows than that raise) so every batch
    has one shape."""

    def __init__(self, max_length: int, pad_token_id: int = 0,
                 mask_prompt: bool = True, packing: bool = False,
                 pack_rows: Optional[int] = None):
        self.max_length = max_length
        self.pad_token_id = pad_token_id
        self.mask_prompt = mask_prompt
        self.packing = packing
        self.pack_rows = pack_rows

    def _fit(self, ex):
        prompt = list(ex["prompt_ids"])
        resp = list(ex["response_ids"])
        seq = (prompt + resp)[:self.max_length]
        lstart = min(len(prompt), self.max_length) if self.mask_prompt else 0
        return seq, lstart

    def __call__(self, examples) -> Dict[str, torch.Tensor]:
        L = self.max_length
        if not self.packing:
            ids = np.full((len(examples), L), self.pad_token_id, np.int64)
            mask = np.zeros((len(examples), L), np.int64)
            for i, ex in enumerate(examples):
                seq, lstart = self._fit(ex)
                ids[i, :len(seq)] = seq
                mask[i, lstart:len(seq)] = 1
            return {"input_ids": torch.from_numpy(ids),
                    "loss_mask": torch.from_numpy(mask)}

        # greedy first-fit packing into rows of max_length
        rows = []  # each: {"ids": [...], "mask": [...], "seg": [...], "n": k}
        for ex in examples:
            seq, lstart = self._fit(ex)
            for row in rows:
                if len(row["ids"]) + len(seq) <= L:
                    break
            else:
                row = {"ids": [], "mask": [], "seg": [], "n": 0}
                rows.append(row)
            row["n"] += 1
            row["ids"].extend(seq)
            row["mask"].extend([0] * lstart + [1] * (len(seq) - lstart))
            row["seg"].extend([row["n"]] * len(seq))

        n_rows = len(rows)
        if self.pack_rows is not None:
            if n_rows > self.pack_rows:
                raise ValueError(
                    f"packing needed {n_rows} rows > pack_rows="
                    f"{self.pack_rows}; raise pack_rows or max_length")
            n_rows = self.pack_rows
        ids = np.full((n_rows, L), self.pad_token_id, np.int64)
        mask = np.zeros((n_rows, L), np.int64)
        segs = np.zeros((n_rows, L), np.int32)
        for i, row in enumerate(rows):
            ids[i, :len(row["ids"])] = row["ids"]
            mask[i, :len(row["mask"])] = row["mask"]
            segs[i, :len(row["seg"])] = row["seg"]
        return {"input_ids": torch.from_numpy(ids),
                "loss_mask": torch.from_numpy(mask),
                "segment_ids": torch.from_numpy(segs)}


def packed_sft_inputs(segment_ids, with_mask: bool = True):
    """segment_ids [b, s] -> (positions [b, s], attn_mask [b, 1, s, s]).

    Attention is causal and inside a segment (tokens never attend across
    packed examples), and RoPE positions restart at each example's first
    token. ``with_mask=False`` skips the O(s^2) mask and returns
    (positions, None): the route of a model that takes ``segment_ids``
    itself (the flash kernels' segment route)."""
    seg = segment_ids
    s = seg.shape[-1]
    idx = torch.arange(s, device=seg.device)
    # position = index - index of the segment's start: the running max of
    # the indices where the segment id changes
    change = torch.cat([torch.ones_like(seg[:, :1], dtype=torch.bool),
                        seg[:, 1:] != seg[:, :-1]], dim=1)
    start_idx = torch.cummax(torch.where(change, idx[None, :], 0),
                             dim=1).values
    positions = idx[None, :] - start_idx
    if not with_mask:
        return positions, None
    causal = idx[None, :, None] >= idx[None, None, :]
    same_seg = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
    # pad rows (seg 0) attend only themselves: an all-masked softmax row
    # would be NaN and reach the real rows in the next layer
    self_only = idx[:, None] == idx[None, :]
    attn = torch.where(seg[:, :, None] > 0, causal & same_seg,
                       self_only[None])
    return positions, attn[:, None]


def _model_takes_segment_ids(model) -> bool:
    try:
        return "segment_ids" in inspect.signature(
            type(model).forward).parameters
    except (TypeError, ValueError):
        return False


def _make_sft_loss(supports_seg: bool):
    def loss_fn(model, batch):
        ids = batch["input_ids"]
        if "segment_ids" in batch:  # packed rows: causal per segment
            seg = batch["segment_ids"]
            if supports_seg:
                # segment ids, not a dense [s, s] mask: attention takes
                # the flash kernels' segment route where the shapes admit
                # it, and the dense route builds the same mask itself
                positions, _ = packed_sft_inputs(seg, with_mask=False)
                logits = model(ids, positions=positions, segment_ids=seg)
            else:
                # a forward without a segment_ids parameter: the explicit
                # block-causal mask
                positions, attn = packed_sft_inputs(seg)
                logits = model(ids, positions=positions, attn_mask=attn)
            return sft_loss(logits, ids, batch["loss_mask"],
                            segment_ids=seg)
        return sft_loss(model(ids), ids, batch["loss_mask"])
    return loss_fn


class SFTTrainer(Trainer):
    """Trainer with the masked SFT loss over dict batches (reference:
    paddlenlp.trl.SFTTrainer), padded or packed (``segment_ids``)."""

    def __init__(self, model, optimizer, args: Optional[TrainingArguments]
                 = None, **kw):
        # chosen by the forward's signature, not by catching a TypeError
        # around the call: a real TypeError inside a segment-aware model
        # must surface, not reroute to the mask
        kw.setdefault("loss_fn", _make_sft_loss(
            _model_takes_segment_ids(model)))
        super().__init__(model, optimizer, args, **kw)


def make_dpo_loss_fn(beta: float = 0.1, label_smoothing: float = 0.0
                     ) -> Callable:
    """Trainer loss_fn for DPO batches: {"chosen_ids", "chosen_mask",
    "rejected_ids", "rejected_mask", "ref_chosen_logps",
    "ref_rejected_logps"} (the reference log-probs computed before)."""

    def loss_fn(model, batch):
        # one [2b, s] forward over chosen and rejected together
        b = batch["chosen_ids"].shape[0]
        ids = torch.cat([batch["chosen_ids"], batch["rejected_ids"]])
        mask = torch.cat([batch["chosen_mask"], batch["rejected_mask"]])
        logps = sequence_logps(model(ids), ids, mask)
        loss, _, _ = dpo_loss(logps[:b], logps[b:],
                              batch["ref_chosen_logps"],
                              batch["ref_rejected_logps"], beta,
                              label_smoothing)
        return loss

    return loss_fn


class DPOTrainer(Trainer):
    """Trainer with the DPO preference loss (reference:
    paddlenlp.trl.DPOTrainer). Put the reference log-probs
    (``compute_sequence_logps(ref_model, ...)``) into the batches."""

    def __init__(self, model, optimizer, args: Optional[TrainingArguments]
                 = None, beta: float = 0.1, label_smoothing: float = 0.0,
                 **kw):
        kw.setdefault("loss_fn", make_dpo_loss_fn(beta, label_smoothing))
        super().__init__(model, optimizer, args, **kw)
