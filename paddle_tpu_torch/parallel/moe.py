"""Mixture-of-Experts (counterpart of ``paddle_tpu/parallel/moe.py``:
``_select_topk``, ``top_k_routing``, ``MoEMLP`` and
``update_loss_free_bias``).

The JAX package's GShard design, on one card: the experts are stacked
parameters ``w_gate``/``w_up`` [E, h, m] and ``w_down`` [E, m, h] in the
JAX layout (so ``load_jax_state_dict`` copies them without a transpose,
as it does the router ``gate`` [h, E], the ``shared_*`` projections and
``shared_expert_gate``), and every expert multiplies a fixed bucket of
``capacity`` rows, whatever the routing put there: static shapes, so a
decode step is one captured graph. The ``ep`` sharding is the identity
on one device.

Routing is the JAX package's, decision for decision: scores in fp32
(the router product ``x.float() @ gate.float()``; TF32 must stay off),
softmax or sigmoid, the bias only for selection, group-limited selection
with -inf for ineligible groups, top-k with the lower expert index first
among equal scores (``jax.lax.top_k``'s order, which ``torch.topk`` does
not promise: a stable descending sort gives it), GShard capacity
``max(ceil(cf * T * k / E), 4)`` over all T tokens of the call, choice-
major priority and drops beyond capacity. The JAX package multiplies
one-hot [T, E, C] dispatch and combine tensors into the buckets; here
the same buckets are filled by index (each (expert, slot) holds at most
one token, so the gather is the one-hot product exactly) and the combine
gathers each token's k expert rows back. :func:`top_k_routing` still
returns the dense [T, E, C] tensors, for callers of the JAX API.

Nothing on this path reads the device from the host (no ``nonzero``,
boolean-mask indexing, ``one_hot`` range checks or ``.item()``), so a
decode step through it can be captured into a CUDA graph. The device
time of the routing and of the expert products is marked with profiler
ranges (``moe_route``, ``moe_experts``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.profiler import record_function

from ..device import resolve_device
from ..nn import functional as F
from .sharding import constraint

__all__ = ["top_k_routing", "MoEMLP"]


def _top_k(x, k: int):
    """(values, indices) of the ``k`` largest along the last dim, in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select_topk(router_logits, k, bias, n_group, topk_group, scoring,
                 group_score_mode):
    """Expert selection (scores, bias correction, group limiting, top-k),
    shared by the dispatch and by ``update_loss_free_bias``. Returns the
    fp32 scores [T, E] and the chosen experts [T, k]."""
    T, E = router_logits.shape
    logits = router_logits.float()
    if scoring == "sigmoid":   # DeepSeek-V3: independent expert scores
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, dim=-1)
    select_scores = probs if bias is None else probs + bias[None, :]
    if n_group > 1:
        g = select_scores.reshape(T, n_group, E // n_group)
        if group_score_mode == "top2_sum":   # DeepSeek-V3 group score
            top2, _ = _top_k(g, 2)
            group_scores = top2.sum(dim=-1)                  # [T, G]
        else:
            group_scores = g.amax(dim=-1)                    # [T, G]
        _, top_groups = _top_k(group_scores, topk_group)
        group_ok = (torch.arange(n_group, device=logits.device)[None, :, None]
                    == top_groups[:, None, :]).any(dim=-1)   # [T, G]
        # -inf, not 0: a bias can push eligible scores negative, and an
        # ineligible expert must never outrank them
        select_scores = torch.where(
            group_ok.repeat_interleave(E // n_group, dim=1), select_scores,
            torch.full((), float("-inf"), device=logits.device))
    _, expert_ids = _top_k(select_scores, k)                 # [T, k]
    return probs, expert_ids


def _route(router_logits, k: int, capacity: int, bias=None,
           norm_topk_prob: bool = False, n_group: int = 1,
           topk_group: int = 1, scoring: str = "softmax",
           group_score_mode: str = "max"):
    """The routing of :func:`top_k_routing` per choice: (experts [T, k],
    bucket slots [T, k] (clamped to capacity - 1), kept [T, k] bool, gates
    [T, k] fp32 (0 where dropped), aux loss)."""
    T, E = router_logits.shape
    probs, ids = _select_topk(router_logits, k, bias, n_group, topk_group,
                              scoring, group_score_mode)
    dev = router_logits.device
    onehot = (ids[..., None] == torch.arange(E, device=dev)).float()
    gates = probs.gather(1, ids)                             # [T, k]
    if norm_topk_prob:
        gates = gates / gates.sum(dim=1, keepdim=True).clamp_min(1e-9)
    # each choice's position in its expert's bucket: over the T*k choices,
    # choice rank first, then token order (GShard's priority)
    flat = onehot.transpose(0, 1).reshape(k * T, E)          # choice-major
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(k, T, E) \
        .transpose(0, 1).gather(2, ids[..., None])[..., 0]   # [T, k]
    keep = pos < capacity
    slot = pos.clamp(max=capacity - 1).long()
    gates = gates * keep
    # switch aux loss: E * sum_e mean_prob_e * mean_frac_e; sigmoid
    # scores are normalized first
    frac = onehot[:, 0, :].mean(dim=0)
    pn = probs / probs.sum(dim=-1, keepdim=True).clamp_min(1e-9) \
        if scoring == "sigmoid" else probs
    aux = E * (frac * pn.mean(dim=0)).sum()
    return ids, slot, keep, gates, aux


def top_k_routing(router_logits, k: int, capacity: int,
                  bias: Optional[torch.Tensor] = None,
                  norm_topk_prob: bool = False,
                  n_group: int = 1, topk_group: int = 1,
                  scoring: str = "softmax",
                  group_score_mode: str = "max"):
    """router_logits [T, E] -> (dispatch [T, E, C], combine [T, E, C],
    aux_loss scalar), fp32: GShard top-k with per-expert capacity C.
    ``norm_topk_prob`` renormalizes the selected gates to sum to 1;
    ``n_group > 1`` is DeepSeek's group-limited greedy selection (only
    the top ``topk_group`` groups stay eligible)."""
    T, E = router_logits.shape
    ids, slot, keep, gates, aux = _route(
        router_logits, k, capacity, bias, norm_topk_prob, n_group,
        topk_group, scoring, group_score_mode)
    dev = router_logits.device
    dispatch = torch.zeros(T, E, capacity, device=dev)
    combine = torch.zeros(T, E, capacity, device=dev)
    tok = torch.arange(T, device=dev)[:, None].expand(T, k)
    # a token's k experts are distinct: no two choices share an index
    dispatch.index_put_((tok, ids, slot), keep.float())
    combine.index_put_((tok, ids, slot), gates)
    return dispatch, combine, aux


def _jax_xavier(shape, generator, device, dtype):
    """A parameter in the JAX package's layout, drawn with its Xavier
    normal fans (2-D [in, out]; 3-D [E, in, out] counts in * out and
    E * out)."""
    if len(shape) == 2:
        fan_in, fan_out = shape
    else:
        fan_in, fan_out = shape[1] * shape[2], shape[0] * shape[2]
    draw = torch.empty(shape, dtype=torch.float32, device=device)
    draw.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                 generator=generator)
    return nn.Parameter(draw.to(dtype))


class MoEMLP(nn.Module):
    """A dense FFN's drop-in: k-of-E SwiGLU experts with optional
    always-on shared experts (the Qwen2-MoE / DeepSeekMoE pattern)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25,
                 num_shared_experts: int = 0,
                 shared_intermediate_size: Optional[int] = None,
                 aux_loss_weight: float = 0.01,
                 use_shared_expert_gate: bool = False,
                 norm_topk_prob: bool = False,
                 routed_scaling_factor: float = 1.0,
                 n_group: int = 1, topk_group: int = 1,
                 scoring: str = "softmax",
                 group_score_mode: str = "max", *, device=None,
                 generator: torch.Generator, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.norm_topk_prob = norm_topk_prob
        # DeepSeek-V2/V3: the routed (not shared) output is scaled
        self.routed_scaling_factor = routed_scaling_factor
        self.n_group, self.topk_group = n_group, topk_group
        self.scoring, self.group_score_mode = scoring, group_score_mode
        E, h, m = num_experts, hidden_size, intermediate_size
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.gate = _jax_xavier((h, E), **kw)          # router
        self.w_gate = _jax_xavier((E, h, m), **kw)
        self.w_up = _jax_xavier((E, h, m), **kw)
        self.w_down = _jax_xavier((E, m, h), **kw)
        # loss-free balancing bias: selection only, updated outside the
        # gradient path; in the weights' dtype, as the JAX package casts it
        self.register_buffer("expert_bias",
                             torch.zeros(E, device=device, dtype=dtype))
        self.shared = None
        self.has_shared_gate = False
        if num_shared_experts:
            sm = shared_intermediate_size or m * num_shared_experts
            self.shared_gate_proj = _jax_xavier((h, sm), **kw)
            self.shared_up_proj = _jax_xavier((h, sm), **kw)
            self.shared_down_proj = _jax_xavier((sm, h), **kw)
            self.shared = True
            if use_shared_expert_gate:
                # Qwen2-MoE: a learned sigmoid gate on the token scales
                # the shared expert's output
                self.shared_expert_gate = _jax_xavier((h, 1), **kw)
                self.has_shared_gate = True

    def capacity(self, tokens: int) -> int:
        c = int(math.ceil(self.capacity_factor * tokens * self.top_k
                          / self.num_experts))
        return max(c, 4)

    def forward(self, x, return_aux: bool = False):
        orig_shape = x.shape
        h, E, k = self.hidden_size, self.num_experts, self.top_k
        xt = x.reshape(-1, h)                              # [T, h]
        T = xt.shape[0]
        C = self.capacity(T)
        with record_function("moe_route"):
            logits = xt.float() @ self.gate.float()
            ids, slot, keep, gates, aux = _route(
                logits, k, C, bias=self.expert_bias,
                norm_topk_prob=self.norm_topk_prob, n_group=self.n_group,
                topk_group=self.topk_group, scoring=self.scoring,
                group_score_mode=self.group_score_mode)
            # each bucket slot's token (T: an empty slot, a zero row);
            # dropped choices all land in the extra slot E*C, unread
            at = torch.where(keep, ids * C + slot,
                             torch.full_like(slot, E * C)).reshape(-1)
            src = torch.full((E * C + 1,), T, dtype=torch.long,
                             device=x.device)
            src.scatter_(0, at, torch.arange(T, device=x.device)
                         .repeat_interleave(k))
            xe = torch.cat([xt, xt.new_zeros(1, h)])[src[:E * C]] \
                .reshape(E, C, h)
            xe = constraint(xe, "ep", None, None)
        with record_function("moe_experts"):
            # per-expert SwiGLU over every bucket, batched over E
            g = torch.bmm(xe, self.w_gate)
            u = torch.bmm(xe, self.w_up)
            ye = torch.bmm(F.silu(g) * u, self.w_down)         # [E, C, h]
            ye = constraint(ye, "ep", None, None)
        with record_function("moe_route"):
            # the combine: each token's kept expert rows, weighted by its
            # gates rounded to the activations' dtype and summed in fp32
            rows = ye.reshape(E * C, h)[(ids * C + slot).reshape(-1)] \
                .reshape(T, k, h)
            w = gates.to(x.dtype).float()
            y = (rows.float() * w[..., None]).sum(dim=1).to(x.dtype)
        if self.routed_scaling_factor != 1.0:
            y = y * self.routed_scaling_factor
        if self.shared:
            sg = F.silu(xt @ self.shared_gate_proj) \
                * (xt @ self.shared_up_proj)
            so = sg @ self.shared_down_proj
            if self.has_shared_gate:
                so = torch.sigmoid(
                    xt.float() @ self.shared_expert_gate.float()
                ).to(so.dtype) * so
            y = y + so
        y = y.reshape(orig_shape)
        if return_aux:
            return y, self.aux_loss_weight * aux
        return y

    @torch.no_grad()
    def update_loss_free_bias(self, router_logits, lr: float = 1e-3):
        """DeepSeek-V3 loss-free balancing: move each expert's bias
        against its load error, through the same selection as the
        dispatch (the load the router really produces). In place."""
        _, ids = _select_topk(router_logits, self.top_k, self.expert_bias,
                              self.n_group, self.topk_group, self.scoring,
                              self.group_score_mode)
        E = self.num_experts
        load = (ids[..., None] == torch.arange(E, device=ids.device)) \
            .float().sum(dim=1).mean(dim=0)
        err = load - self.top_k / E
        self.expert_bias.copy_(self.expert_bias - lr * torch.sign(err))
        return self.expert_bias
