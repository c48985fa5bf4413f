"""The port's ``parallel/moe.py`` against the JAX package's, on the same
fp32 router logits and weights (CPU).

- ``top_k_routing``: the dispatch tensor equal exactly (every routing
  decision: the experts, their order, the bucket slots, the drops) and
  the combine tensor nonzero at exactly the same places. Its values are
  the router's softmax / sigmoid scores, which XLA's exp and torch's
  round differently in the last bit, so they agree within
  ``TOL_GATES_ULP`` fp32 ulps; the aux loss (~1, a mean over tokens
  summed in another order) within ``TOL_AUX_ULP``. Measured on these
  inputs: six of the nine cases' combine tensors differ from the JAX
  one, each by at most 1 ulp, and the softmax case's aux by 2 ulps
  (1.2408068 against 1.2408071); ``test_routing_gates_differ_by_an_ulp``
  pins that exact equality does not hold. Cases:
  softmax and sigmoid, ``n_group`` 1 and 4, ``max`` and ``top2_sum``,
  ``norm_topk_prob``, a selection bias, a capacity that overflows, and
  tied scores (``jax.lax.top_k`` puts the lower
  index first; ``torch.topk`` does not promise it).
- ``update_loss_free_bias``: the new bias equal exactly.
- ``MoEMLP``: output and aux within ``TOL_MLP``; the weights cross
  ``load_jax_state_dict`` untransposed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.parallel import moe as jax_moe
from paddle_tpu_torch.parallel import moe

TOL_GATES_ULP = 1    # fp32 ulps: softmax/sigmoid rounding
TOL_AUX_ULP = 2
TOL_MLP = 1e-5

ROUTES = {
    "softmax": dict(),
    "overflow": dict(capacity=3),
    "sigmoid": dict(scoring="sigmoid"),
    "norm": dict(norm_topk_prob=True),
    "bias": dict(bias=True),
    "group-max": dict(n_group=4, topk_group=2),
    "group-top2sum-sigmoid": dict(n_group=4, topk_group=2,
                                  group_score_mode="top2_sum",
                                  scoring="sigmoid", norm_topk_prob=True,
                                  bias=True),
    "ties": dict(ties=True, capacity=4),
    "ties-group": dict(ties=True, n_group=4, topk_group=2, capacity=5),
}


def _routing_inputs(T, E, seed, ties=False, bias=False):
    rs = np.random.RandomState(seed)
    if ties:   # few distinct values: many exactly equal scores
        logits = rs.randint(0, 3, (T, E)).astype(np.float32)
    else:
        logits = (2 * rs.randn(T, E)).astype(np.float32)
    b = (0.1 * rs.randn(E)).astype(np.float32) if bias else None
    return logits, b


def _both_routings(case):
    """(port's, JAX's) (dispatch, combine, aux) of one case, as numpy."""
    kw = dict(ROUTES[case])
    T, E, k = 24, 8, 3
    capacity = kw.pop("capacity", 16)
    logits, bias = _routing_inputs(T, E, seed=len(case),
                                   ties=kw.pop("ties", False),
                                   bias=kw.pop("bias", False))
    ref = jax_moe.top_k_routing(
        jnp.asarray(logits), k, capacity,
        bias=None if bias is None else jnp.asarray(bias), **kw)
    got = moe.top_k_routing(
        torch.from_numpy(logits), k, capacity,
        bias=None if bias is None else torch.from_numpy(bias), **kw)
    return ([t.numpy() for t in got],
            [np.asarray(t, np.float32) for t in ref])


@pytest.mark.parametrize("case", list(ROUTES))
def test_top_k_routing_matches_jax(case):
    T, k = 24, 3
    (gd, gc, ga), (rd, rc, ra) = _both_routings(case)
    np.testing.assert_array_equal(gd, rd)
    np.testing.assert_array_equal(gc != 0, rc != 0)
    np.testing.assert_array_max_ulp(gc, rc, maxulp=TOL_GATES_ULP)
    np.testing.assert_array_max_ulp(ga, ra, maxulp=TOL_AUX_ULP)
    if case == "overflow":   # the case drops: some choices find no slot
        assert gd.sum() < T * k


def test_routing_gates_differ_by_an_ulp():
    """The ulp limits above are the measured rounding, not slack: exact
    equality of the combine values fails on these inputs, and the
    largest gap over the cases is one ulp."""
    gaps = []
    for case in ROUTES:
        (_, gc, _), (_, rc, _) = _both_routings(case)
        gaps.append(int(np.abs(gc.view(np.int32).astype(np.int64)
                               - rc.view(np.int32)).max()))
    assert max(gaps) == TOL_GATES_ULP and sum(g > 0 for g in gaps) == 6


def test_top_k_tie_order_is_jaxs():
    """Equal scores: the lower expert index first, as jax.lax.top_k."""
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0],
                      [2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, idx = moe._top_k(x, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert vals.tolist() == [[3.0, 3.0, 3.0], [2.0, 2.0, 2.0]]


def _pair(seed=0, **kw):
    pt.seed(seed)
    jm = jax_moe.MoEMLP(32, 48, **kw)
    tm = moe.MoEMLP(32, 48, **kw, device="cpu",
                    generator=ptt.make_generator(0, "cpu"))
    params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    ptt.load_jax_state_dict(tm, params)
    return jm, tm, params


MLPS = {
    "qwen2-moe": dict(num_experts=8, top_k=2, num_shared_experts=1,
                      shared_intermediate_size=40,
                      use_shared_expert_gate=True),
    "deepseek-v2": dict(num_experts=8, top_k=3, num_shared_experts=2,
                        routed_scaling_factor=1.5, capacity_factor=0.5),
    "deepseek-v3": dict(num_experts=8, top_k=2, num_shared_experts=1,
                        norm_topk_prob=True, n_group=4, topk_group=2,
                        scoring="sigmoid", group_score_mode="top2_sum",
                        routed_scaling_factor=2.5),
    "no-shared": dict(num_experts=4, top_k=2, capacity_factor=1.0),
}


@pytest.mark.parametrize("case", list(MLPS))
def test_moe_mlp_matches_jax(case):
    jm, tm, params = _pair(**MLPS[case])
    # the JAX layout in both packages: nothing transposed
    for name, t in tm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), params[name], err_msg=name)
    x = np.random.RandomState(4).randn(3, 10, 32).astype(np.float32)
    ry, ra = jm(jnp.asarray(x), return_aux=True)
    with torch.no_grad():
        gy, ga = tm(torch.from_numpy(x), return_aux=True)
    assert gy.shape == (3, 10, 32)
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), atol=TOL_MLP,
                               rtol=0)
    np.testing.assert_allclose(float(ga), float(ra), atol=TOL_MLP, rtol=0)
    assert tm.capacity(30) == jm.capacity(30)


def test_moe_mlp_drops_like_jax():
    """A capacity the tokens overflow (cf 0.25: C = 4 for 30 tokens x 2
    choices over 4 experts): dropped choices contribute nothing, in both
    packages alike."""
    jm, tm, _ = _pair(num_experts=4, top_k=2, capacity_factor=0.25)
    x = np.random.RandomState(5).randn(30, 32).astype(np.float32)
    assert tm.capacity(30) == 4
    ry = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        gy = tm(torch.from_numpy(x))
    np.testing.assert_allclose(gy.numpy(), ry, atol=TOL_MLP, rtol=0)


@pytest.mark.parametrize("case", ["softmax", "deepseek-v3"])
def test_update_loss_free_bias_matches_jax(case):
    kw = MLPS["no-shared" if case == "softmax" else "deepseek-v3"]
    jm, tm, _ = _pair(**kw)
    logits = np.random.RandomState(6).randn(40, kw["num_experts"]) \
        .astype(np.float32)
    for _ in range(3):
        ref = np.asarray(jm.update_loss_free_bias(jnp.asarray(logits),
                                                  lr=0.01))
        got = tm.update_loss_free_bias(torch.from_numpy(logits), lr=0.01)
        np.testing.assert_array_equal(got.numpy(), ref)
    assert np.abs(ref).max() > 0
