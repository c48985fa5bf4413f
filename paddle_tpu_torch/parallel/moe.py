"""Mixture-of-Experts (counterpart of ``paddle_tpu/parallel/moe.py``:
``_select_topk``, ``top_k_routing``, ``MoEMLP`` and
``update_loss_free_bias``).

The JAX package's GShard design, on one card: the experts are stacked
parameters ``w_gate``/``w_up`` [E, h, m] and ``w_down`` [E, m, h] in the
JAX layout (so ``load_jax_state_dict`` copies them without a transpose,
as it does the router ``gate`` [h, E], the ``shared_*`` projections and
``shared_expert_gate``), and every expert multiplies a fixed bucket of
``capacity`` rows, whatever the routing put there: static shapes, so a
decode step is one captured graph.

On a mesh, what GSPMD computes for the JAX layer is written out. The
JAX package splits activations over dp and fsdp (and sp) only, and
routes the logical array: every token of the call competes for one
capacity. So the layer gathers the call's tokens over the axes that
split the data (an ``all_gather`` whose gradient is the reduce-scatter)
and every rank makes the same routing decisions. The experts carry the
JAX partition ``("ep", None, None)``: an ep rank holds E / ep of them
(its DTensor shard), fills and multiplies only their buckets, and the
combine's sum over experts becomes a sum over ep (Megatron's f and g
over ``ep``: ``parallel.layers.copy_to`` / ``reduce_from``). Each ep
rank sees the same tokens and holds the whole loss, so no gradient is
summed over ep. With every axis of degree 1 none of this runs. Serving
(a mesh of tp and ep) splits no data: every rank routes the same tokens
(the residual the tp row layers all-reduced, the same bits on every
rank), so their decisions agree and nothing is gathered; at ep > 1 the
ownership masks and the sum over ep run inside the captured decode step
and tick.

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
from ..distributed import collective as C
from ..distributed.env import BATCH_AXES, axis_coordinate, axis_degree
from ..nn import functional as F
from ..nn.common import set_partition
from .layers import copy_to, reduce_from
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


def _call_tokens(x):
    """(the tokens of the whole call [T, h], the rows of this rank's
    tokens in them or None). ``x`` is this rank's block, [b, s, h] (or
    [b, h]): its rows of the batch over dp x fsdp and, for [b, s, h],
    its positions over sp. The gather orders the tokens as the JAX
    layer's logical ``x.reshape(-1, h)`` does."""
    h = x.shape[-1]
    deg = axis_degree(BATCH_AXES)
    sp = axis_degree("sp") if x.dim() >= 3 else 1
    if deg == 1 and sp == 1:
        return x.reshape(-1, h), None
    g = x
    if sp > 1:
        g = C.all_gather(g, "sp", axis=1)
    if deg > 1:
        g = C.all_gather(g, BATCH_AXES, axis=0)
    dev = x.device
    rows = axis_coordinate(BATCH_AXES) * x.shape[0] + torch.arange(
        x.shape[0], device=dev)
    if x.dim() >= 3:
        cols = axis_coordinate("sp") * x.shape[1] + torch.arange(
            x.shape[1], device=dev)
        mine = (rows[:, None] * g.shape[1] + cols[None, :]).reshape(-1)
    else:
        mine = rows
    return g.reshape(-1, h), mine


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
        for w in (self.w_gate, self.w_up, self.w_down):
            set_partition(w, ("ep", None, None))
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
        xt = x.reshape(-1, h)                              # [T_l, h]
        # the call's tokens: this rank's, or on a mesh every rank's of
        # the axes that split the data (one routing for all of them)
        xg, mine = _call_tokens(x)                         # [T, h]
        T = xg.shape[0]
        C = self.capacity(T)
        # this rank's experts: all E, or its E / ep shard under ep. With
        # all E here the ownership masks below would be all true: the
        # unsplit path leaves their elementwise launches out of the
        # captured decode step
        El = self.w_gate.shape[0]
        split = El != E
        e0 = axis_coordinate("ep") * El if split else 0
        with record_function("moe_route"):
            logits = xg.float() @ self.gate.float()
            ids, slot, keep, gates, aux = _route(
                logits, k, C, bias=self.expert_bias,
                norm_topk_prob=self.norm_topk_prob, n_group=self.n_group,
                topk_group=self.topk_group, scoring=self.scoring,
                group_score_mode=self.group_score_mode)
            if split:
                # the buckets' tokens and the gates enter work split
                # over ep: their gradients sum over it
                xg, gates = copy_to(xg, "ep"), copy_to(gates, "ep")
                own = (ids >= e0) & (ids < e0 + El)
            # each bucket slot's token (T: an empty slot, a zero row);
            # dropped choices, and others' experts, all land in the
            # extra slot El*C, unread
            fill = keep & own if split else keep
            at = torch.where(fill, (ids - e0) * C + slot,
                             torch.full_like(slot, El * C)).reshape(-1)
            src = torch.full((El * C + 1,), T, dtype=torch.long,
                             device=x.device)
            src.scatter_(0, at, torch.arange(T, device=x.device)
                         .repeat_interleave(k))
            xe = torch.cat([xg, xg.new_zeros(1, h)])[src[:El * C]] \
                .reshape(El, C, h)
            xe = constraint(xe, "ep", None, None)
        with record_function("moe_experts"):
            # per-expert SwiGLU over every bucket, batched over E
            g = torch.bmm(xe, self.w_gate)
            u = torch.bmm(xe, self.w_up)
            ye = torch.bmm(F.silu(g) * u, self.w_down)         # [El, C, h]
            ye = constraint(ye, "ep", None, None)
        with record_function("moe_route"):
            # the combine, for this rank's tokens: each token's kept
            # expert rows, weighted by its gates rounded to the
            # activations' dtype and summed in fp32 (over ep too)
            if mine is not None:
                ids, slot, gates = ids[mine], slot[mine], gates[mine]
            Tl = ids.shape[0]
            w = gates.to(x.dtype).float()
            if split:
                own = (ids >= e0) & (ids < e0 + El)
                at = torch.where(own, (ids - e0) * C + slot,
                                 torch.zeros_like(slot))
                w = torch.where(own, w, torch.zeros_like(w))
            else:
                at = ids * C + slot
            rows = ye.reshape(El * C, h)[at.reshape(-1)].reshape(Tl, k, h)
            y = (rows.float() * w[..., None]).sum(dim=1)
            if split:
                y = reduce_from(y, "ep")
            y = y.to(x.dtype)
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
