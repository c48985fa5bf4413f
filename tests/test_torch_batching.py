"""The port's ``BatchingPredictor`` against the JAX package's, the cases
of ``tests/test_inference.py`` (coalescing, errors) and the batching
cases of ``tests/test_faults.py`` (backpressure, timeouts, drain) and
``tests/test_observability.py`` (health() is the registry).

Outputs are held to the port's own ``Predictor.run`` of each row alone
and to the JAX package's on the same weights (fp32, within 1e-5: a batch
of 8 sums its matmuls in another order than a row alone, as the JAX
test's rtol 1e-5 allows)."""
import threading
import time
from concurrent.futures import CancelledError, wait

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu_torch.inference import (BackpressureError,
                                        BatchingPredictor,
                                        RequestTimeoutError)
from paddle_tpu_torch.utils import observability as obs

TOL = 1e-5


def _jax_mlp():
    pt.seed(0)
    return jnn.Sequential(jnn.Linear(16, 32), jnn.GELU(), jnn.Linear(32, 4))


def _mlp(jm=None):
    """The JAX MLP's weights in a torch MLP ([in, out] -> [out, in])."""
    jm = jm or _jax_mlp()
    sd = {k: np.array(v) for k, v in jm.state_dict().items()}
    m = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(),
                            torch.nn.Linear(32, 4))
    with torch.no_grad():
        for i in (0, 2):
            m[i].weight.copy_(torch.from_numpy(sd[f"{i}.weight"].T.copy()))
            m[i].bias.copy_(torch.from_numpy(sd[f"{i}.bias"]))
    return m


def _slow(bp, seconds):
    orig = bp.predictor.run

    def slow(*a):
        time.sleep(seconds)
        return orig(*a)
    bp.predictor.run = slow


def test_coalesces_and_answers_each():
    jm = _jax_mlp()
    bp = BatchingPredictor(_mlp(jm), max_batch=8, max_delay_ms=20,
                           device="cpu")
    try:
        rs = np.random.RandomState(1)
        xs = [rs.randn(16).astype(np.float32) for _ in range(12)]
        futs = [bp.submit(x) for x in xs]
        wait(futs, timeout=60)
        ref = ptt.Predictor(bp.predictor.model, device="cpu")
        jref = JaxPredictor(jm)
        for x, f in zip(xs, futs):
            got = f.result().numpy()
            np.testing.assert_allclose(got, ref.run(x[None])[0].numpy(),
                                       atol=TOL, rtol=0)
            np.testing.assert_allclose(
                got, np.asarray(jref.run(x[None]))[0], atol=TOL, rtol=0)
        assert bp.health()["batches"] < 12
    finally:
        bp.close()


def test_propagates_errors():
    bp = BatchingPredictor(_mlp(), max_batch=4, max_delay_ms=1,
                           device="cpu")
    try:
        fut = bp.submit(np.zeros((99,), np.float32))   # wrong feature dim
        assert fut.exception(timeout=30) is not None
        assert bp.health()["errors"] == 1
    finally:
        bp.close()


def test_overload_rejects_while_inflight_completes():
    bp = BatchingPredictor(_mlp(), max_batch=2, max_delay_ms=1,
                           max_queue=2, device="cpu")
    try:
        _slow(bp, 0.15)
        xs = [np.random.RandomState(i).randn(16).astype(np.float32)
              for i in range(10)]
        futs, rejected = [], 0
        for x in xs:
            try:
                futs.append(bp.submit(x))
            except BackpressureError:
                rejected += 1
        assert rejected >= 1 and futs
        for f in futs:
            assert f.result(timeout=30).shape == (4,)
        h = bp.health()
        assert h["served"] == len(futs) and h["rejected"] == rejected
        assert h["queued"] == 0 and h["worker_alive"]
    finally:
        bp.close()
    h = bp.health()
    assert h["closed"] and not h["worker_alive"]


def test_request_timeout_and_graceful_drain():
    bp = BatchingPredictor(_mlp(), max_batch=1, max_delay_ms=1,
                           device="cpu")
    _slow(bp, 0.25)
    x = np.zeros((16,), np.float32)
    blocker = bp.submit(x)
    time.sleep(0.1)                    # the collector is inside run()
    doomed = bp.submit(x, timeout_s=0.05)
    tail = bp.submit(x)
    with pytest.raises(RequestTimeoutError):
        doomed.result(timeout=30)
    assert blocker.result(timeout=30).shape == (4,)
    bp.close()                         # a graceful drain serves the tail
    assert tail.result(timeout=5).shape == (4,)
    assert bp.health()["timeouts"] == 1
    with pytest.raises(RuntimeError):
        bp.submit(x)


def test_close_without_drain_fails_queued_fast():
    bp = BatchingPredictor(_mlp(), max_batch=1, max_delay_ms=1,
                           device="cpu")
    _slow(bp, 0.3)
    x = np.zeros((16,), np.float32)
    blocker = bp.submit(x)
    time.sleep(0.05)
    queued = [bp.submit(x) for _ in range(3)]
    bp.close(drain=False)
    assert blocker.result(timeout=30).shape == (4,)
    for f in queued:
        with pytest.raises((CancelledError, RuntimeError)):
            f.result(timeout=5)


def test_health_matches_registry_under_concurrent_submits():
    """Every submitted request resolves exactly once, and health() reads
    the registry's own counters and queue-wait histogram."""
    bp = BatchingPredictor(_mlp(), max_batch=2, max_delay_ms=1,
                           max_queue=4, device="cpu")
    _slow(bp, 0.05)
    x = np.zeros((16,), np.float32)
    futs, rejected, attempts = [], 0, 24
    lock = threading.Lock()

    def submit_some():
        nonlocal rejected
        for _ in range(attempts // 4):
            try:
                f = bp.submit(x)
                with lock:
                    futs.append(f)
            except BackpressureError:
                with lock:
                    rejected += 1
            time.sleep(0.001)

    ts = [threading.Thread(target=submit_some) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    cancelled = sum(f.cancel() for f in futs[-3:])
    bp.close()
    h = bp.health()
    assert h["submitted"] == len(futs)
    assert h["submitted"] + h["rejected"] == attempts
    assert h["rejected"] == rejected >= 1
    assert h["cancelled"] == cancelled
    assert h["served"] + h["cancelled"] + h["timeouts"] + h["errors"] \
        == h["submitted"]
    assert h["queued"] == 0
    snap = obs.registry().snapshot()
    eng = bp._obs_labels["engine"]
    for key in BatchingPredictor._STAT_KEYS:
        assert snap[f'serving_{key}_total{{engine="{eng}"}}'] == h[key]
    assert snap[f'serving_queue_wait_ms{{engine="{eng}"}}']["count"] \
        >= h["served"]


def test_generate_requests_equal_their_batch_through_generate():
    """With the predictor's engine call set to ``Predictor.generate``,
    every answer is bit for bit its row of the same stacked batch through
    ``Predictor.generate``."""
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    bp = BatchingPredictor(tm, max_batch=4, max_delay_ms=20, device="cpu")
    seen = []
    orig = bp.predictor.generate

    def record(ids):
        seen.append(np.array(ids))
        return orig(ids, max_new_tokens=5)
    bp.predictor.run = record
    try:
        rs = np.random.RandomState(2)
        xs = [rs.randint(0, 256, (7,)) for _ in range(6)]
        futs = [bp.submit(x) for x in xs]
        outs = [f.result(timeout=60) for f in futs]
    finally:
        bp.close()
    assert sum(len(s) for s in seen) == 6 and len(seen) < 6
    ref = {}
    for batch in seen:
        got = orig(batch, max_new_tokens=5)
        for row, ids in zip(got, batch):
            ref[tuple(ids)] = row
    for x, out in zip(xs, outs):
        assert out.shape == (12,)
        assert torch.equal(out, ref[tuple(x)])
