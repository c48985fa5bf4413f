"""Tensor-parallel serving behind the gateway and the fleet, on the CPU.

A tp replica is N rank processes; rank 0 serves the gateway over a
``SequencedEngine`` and every engine call reaches the other ranks, in
order, before each step.

- In spawned gloo worlds of 2 and 4 ranks (``tests/torch_dist_workers.py``
  ``tp_gateway_cases``), the port's gateway serves the JAX package's
  ``_dryrun_paged_tp`` requests over HTTP: greedy streams equal the JAX
  ``Gateway``'s over the JAX ``PagedEngine`` on the same tp mesh (this
  process, ``jax.devices()[:tp]``), logprobs within 1e-4; the sampled
  stream is the same on every rank and bit for bit the port's tp engine
  driven directly. At tp 2 also a client disconnect, a deadline
  mid-stream, an idle gap, a hang on rank 0 answered by a sequenced
  ``hard_reset``, a span spilled and restored on every rank and a drain
  that migrates a live stream. The schedule digest, compared every step,
  never parts (it would raise), every rank ends with the same counters,
  and the drain ends every rank with exit 0.
- Processes: two ``replica_main --tp 2 --model tiny`` replicas spawned by
  ``LocalProcessManager(tp=2)`` through the launcher behind a
  ``FleetFrontend``; one replica's follower is SIGKILLed mid-stream:
  every stream completes on the other replica, each greedy one bit for
  bit a direct tp engine's resume of its committed prefix (a reference
  world), and the killed replica's processes are gone within the
  watchdog's limit plus the launcher's grace. A third replica is killed
  through the manager (its whole process group) and the survivor drains
  on SIGTERM with every rank exiting 0. ``loadgen --fleet 1 --tp 2``
  runs end to end.
"""
import asyncio
import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.generation.paged import PagedEngine as JaxEngine
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.parallel.sharding import shard_layer as jax_shard_layer
from paddle_tpu.serving import Gateway as JaxGateway
from paddle_tpu_torch.generation.paged import PagedEngine
from paddle_tpu_torch.serving import Gateway, loadgen
from paddle_tpu_torch.serving.fleet import FleetFrontend, LocalProcessManager
from paddle_tpu_torch.serving.tp_replica import (EXIT_RANK_LOST,
                                                 SequencedEngine)
from paddle_tpu_torch.utils.faults import BackpressureError
from test_torch_gateway_gpu import sse
from torch_dist_workers import SPILL_GEO, TP_GEO, start_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the _dryrun_paged_tp config: 8 query heads over 4 kv heads
CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=8,
           num_key_value_heads=4)
# fp32 logits of sums of up to 128 terms, the tp partial sums added in
# another order than the JAX program's
ATOL = 1e-4
# the fleet's replicas: replica_main --model tiny --tp 2 from this seed
FLEET_SEED, FLEET_CHUNK = 7, 32
WATCHDOG_S = 30.0       # replica_main's default watchdog_timeout_s
DRAIN_GRACE_S = 15.0    # the launcher's grace the manager passes


@contextlib.contextmanager
def _no_cache_writes():
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    try:
        yield
    finally:
        jax.config.update(key, prev)


@contextlib.contextmanager
def _mesh(tp):
    jenv.init_parallel_env({"tp": tp}, devices=jax.devices()[:tp])
    try:
        yield
    finally:
        jenv.init_parallel_env({})


def _jax_model():
    pt.seed(0)
    return JaxLlama(jax_llama_tiny(**CFG))


def _payload():
    rs = np.random.RandomState(3)
    shared = rs.randint(1, 256, 16).tolist()
    ids = lambda n: rs.randint(1, 256, n).tolist()   # noqa: E731
    a = dict(request_id="a", prompt=shared + [3], max_new_tokens=8)
    b = dict(request_id="b", prompt=shared + [5, 7], max_new_tokens=8)
    s = dict(request_id="s", prompt=ids(7), max_new_tokens=8,
             temperature=0.8, top_p=0.9, seed=5)
    spill_a = dict(request_id="A", prompt=ids(17), max_new_tokens=8)
    # two batches of two 33-token requests park their own prefixes and
    # evict A's, the pool's oldest
    spill = [[spill_a]] + [
        [dict(request_id=f"{x}", prompt=ids(17), max_new_tokens=16)
         for x in pair] for pair in ("XY", "ZW")] + [
        [dict(spill_a, request_id="A2")]]
    return dict(cfg=CFG, params={k: np.asarray(v) for k, v in
                                 _jax_model().state_dict().items()},
                gw_reqs=[[a], [b, s]], spill_reqs=spill,
                long=dict(prompt=ids(8), max_new_tokens=40),
                late=dict(request_id="g", prompt=ids(9), max_new_tokens=8))


def _fleet_requests():
    rs = np.random.RandomState(11)
    reqs = [dict(request_id=f"f{i}", prompt=rs.randint(1, 256, 40).tolist(),
                 max_new_tokens=48) for i in range(4)]
    reqs.append(dict(request_id="fs", prompt=rs.randint(1, 256, 40).tolist(),
                     max_new_tokens=48, temperature=0.7, seed=9))
    return reqs


def _jax_gateway(tp, reqs):
    """The JAX Gateway over the JAX PagedEngine on {"tp": tp}: each batch
    of requests over HTTP SSE."""
    with _mesh(tp):
        m = _jax_model()
        jax_shard_layer(m, fsdp_min_size=1 << 30)
        eng = JaxEngine(m, **TP_GEO)

        async def run():
            gw = JaxGateway(eng, name=f"jax-tp{tp}")
            await gw.start()
            got = {}
            try:
                for batch in reqs:
                    res = await asyncio.gather(
                        *[sse(gw.port, r) for r in batch])
                    for r, (st, _, toks, fin) in zip(batch, res):
                        got[r["request_id"]] = (st, toks, fin)
            finally:
                await gw.drain()
            return got
        return asyncio.run(run())


def _gone(pid):
    """The process is gone (or a zombie nobody reaped yet)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def _wait_gone(pids, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(_gone(p) for p in pids):
            return True
        time.sleep(0.05)
    return all(_gone(p) for p in pids)


def _tp_doc(peer):
    doc = peer._get_json("/debugz")
    return doc["replicas"]["r0"]["engine"]


async def _fleet_traffic(fe, mgr, reqs):
    """The requests through ``fe``; the first replica seen holding a
    greedy stream with 4 tokens delivered and 16 to go loses its
    follower rank to SIGKILL. Returns (results, the kill's record)."""
    loop = asyncio.get_running_loop()
    live = {r["request_id"]: [] for r in reqs}
    results = {}

    async def one(r):
        st, _, toks, fin = await sse(fe.port, r)
        results[r["request_id"]] = (st, toks, fin)

    async def watch():
        greedy = {r["request_id"] for r in reqs if "temperature" not in r}
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            for p in list(fe.peers):
                doc = await loop.run_in_executor(None, _tp_doc, p)
                mid = [s["request_id"] for s in doc.get("slots") or ()
                       if s and s["request_id"] in greedy
                       and s["remaining_budget"] >= 16
                       and s["emitted"] >= 4]
                if mid:
                    pids = doc["tp_sequencer"]["pids"]
                    launcher = mgr.procs[p.name]
                    t0 = time.monotonic()
                    os.kill(pids[1], signal.SIGKILL)
                    return dict(peer=p.name, pids=pids, mid=mid, t0=t0,
                                launcher=launcher)
            await asyncio.sleep(0.02)
        raise RuntimeError("no replica held a greedy stream mid-flight")

    tasks = [asyncio.ensure_future(one(r)) for r in reqs]
    kill = await watch()
    await asyncio.gather(*tasks)
    return results, kill


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_gateway")
    p = _payload()
    fleet_reqs = _fleet_requests()
    w2 = start_world("tp_gateway", 2, tmp, p, timeout_s=400)
    w4 = start_world("tp_gateway", 4, tmp, p, timeout_s=400)
    wref = start_world("tp_fleet_reference", 2, tmp,
                       dict(seed=FLEET_SEED, chunk=FLEET_CHUNK,
                            reqs=fleet_reqs), timeout_s=400)
    env = dict(os.environ, PYTHONPATH=ROOT)
    lg = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.loadgen",
         "--fleet", "1", "--tp", "2", "--model", "tiny", "--device", "cpu",
         "--requests", "6", "--rate", "50", "--max-new", "8",
         "--sys-tokens", "32", "--tail-tokens", "8"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    fe = FleetFrontend([], chunk_tokens=FLEET_CHUNK, name="tp-fleet",
                       breaker_backoff_s=60.0)
    kw = dict(model="tiny", chunk_tokens=FLEET_CHUNK, device="cpu",
              seed=FLEET_SEED, tp=2, spawn_timeout_s=240,
              probe_interval_s=0.1, stale_after_s=5.0,
              drain_grace_s=DRAIN_GRACE_S,
              extra_args=["--idle-interval-s", "1"],
              env={"PADDLE_TPU_FAULTS": "slow_replica",
                   "PADDLE_TPU_FAULT_SLOW_REPLICA_S": "0.03"},
              log_dir=str(tmp / "replica_logs"))
    mgr = LocalProcessManager(fe, **kw)
    # a replica outside the frontend, for the manager's kill
    mgr2 = LocalProcessManager(FleetFrontend([], name="tp-fleet-side"),
                               **kw)
    spawned = {}

    def spawn_all():
        ts = [threading.Thread(target=lambda i=i: spawned.__setitem__(
            i, (mgr if i < 2 else mgr2).spawn())) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(300)

    spawner = threading.Thread(target=spawn_all)
    spawner.start()
    out = {"payload": p, "fleet_reqs": fleet_reqs}
    try:
        with _no_cache_writes():
            out["jax"] = {tp: _jax_gateway(tp, p["gw_reqs"])
                          for tp in (2, 4)}
        spawner.join(300)
        assert len(spawned) == 3, f"replicas up: {sorted(spawned)}"
        side = spawned[2]
        side_doc = _tp_doc(side)["tp_sequencer"]
        out["side"] = dict(name=side.name, pids=side_doc["pids"],
                           launcher=mgr2.procs[side.name].pid)
        t0 = time.monotonic()
        mgr2.kill(side.name)
        out["side"]["gone"] = _wait_gone(
            [out["side"]["launcher"]] + side_doc["pids"], 10)
        out["side"]["gone_s"] = time.monotonic() - t0

        async def fleet():
            await fe.start()
            try:
                return await _fleet_traffic(fe, mgr, fleet_reqs)
            finally:
                out["fe_ring"] = fe.ring.snapshot()
                out["fe_health"] = fe.healthz()
                await fe.drain()
        results, kill = asyncio.run(fleet())
        proc = kill.pop("launcher")
        try:
            kill["rc"] = proc.wait(WATCHDOG_S + DRAIN_GRACE_S)
        except subprocess.TimeoutExpired:
            kill["rc"] = None
        kill["gone"] = _wait_gone([proc.pid] + kill["pids"], 5)
        kill["gone_s"] = time.monotonic() - kill["t0"]
        with open(tmp / "replica_logs" / f"{kill['peer']}.stderr.log") as f:
            kill["log"] = f.read()
        out["fleet"], out["kill"] = results, kill
        survivor = next(n for n in mgr.procs if n != kill["peer"])
        sproc = mgr.procs[survivor]
        out["survivor_pids"] = [sproc.pid]
        mgr.stop_all(grace_s=DRAIN_GRACE_S + 10)
        out["survivor_rc"] = sproc.wait(10)
        out["worlds"] = {2: w2.result(), 4: w4.result()}
        out["ref"] = wref.result()[0]
        lg_out, lg_err = lg.communicate(timeout=300)
        out["loadgen"] = (lg.returncode, lg_out, lg_err)
    finally:
        for m in (mgr, mgr2):
            m.stop_all(grace_s=5)
        if lg.poll() is None:
            lg.kill()
            lg.wait(10)
    return out


def _committed(ring):
    """Request id -> tokens committed before the failover, from the
    frontend's ring."""
    out = {}
    for e in ring:
        offs = [f for _, k, f in e.get("events", ())
                if k == "resume_offset"]
        if e.get("failovers"):
            out[e["request_id"]] = offs[-1]["committed"] if offs else 0
    return out


# ------------------------------------------------------------ the worlds
@pytest.mark.parametrize("tp", [2, 4])
def test_gateway_streams_match_the_jax_gateway(served, tp):
    ranks = served["worlds"][tp]
    ref = served["jax"][tp]
    got = ranks[0]["parity"]["leader"]
    direct = ranks[0]["direct"]
    for rid in ("a", "b", "s"):
        st, toks, fin = got[rid]
        assert st == 200 and fin["finish_reason"] == "stop", rid
        assert toks == fin["tokens"] and len(toks) == 8, rid
        # the port's gateway is its own direct tp engine, bit for bit
        assert (toks, fin["logprobs"]) == tuple(direct[rid]), rid
        if rid == "s":
            continue      # JAX threefry keys have no torch counterpart
        jst, jtoks, jfin = ref[rid]
        assert jst == 200 and toks == jtoks, rid
        np.testing.assert_allclose(fin["logprobs"], jfin["logprobs"],
                                   atol=ATOL, rtol=0)
    # b adopted a's parked prefix on every rank
    assert ranks[0]["parity"]["stats"]["prefix_hit_tokens"] > 0
    for r in ranks[1:]:
        # every follower computed the same streams, the sampled one too
        for rid in ("a", "b", "s"):
            assert r["parity"]["keep"][rid] == got[rid][1], rid
            assert r["direct"][rid] == direct[rid], rid


@pytest.mark.parametrize("tp", [2, 4])
def test_every_rank_ends_the_same_and_drain_stops_the_followers(served, tp):
    """Every scenario ends with the same engine counters on every rank
    (the digest, compared each step, never parted: it would have raised),
    and rank 0's drain returned every follower from its loop (the world's
    ranks all exited 0)."""
    ranks = served["worlds"][tp]
    scenarios = ("parity",) if tp == 4 else ("parity", "faults", "spill")
    for name in scenarios:
        lead = ranks[0][name]
        assert lead["seq"]["stopped"] and lead["seq"]["lost"] is None
        for r in ranks[1:]:
            assert r[name]["stats"] == lead["stats"], name
            assert r[name]["follow"]["stopped"], name
            assert r[name]["follow"]["steps"] == lead["seq"]["steps"], name
            assert r[name]["follow"]["batches"] == \
                lead["seq"]["batches"], name


def test_disconnect_and_deadline_reach_every_rank(served):
    ranks = served["worlds"][2]
    res = ranks[0]["faults"]["leader"]
    assert res["disconnect"] == (200, 3) and res["freed"]
    st, n, fin = res["deadline"]
    assert st == 200 and fin["finish_reason"] == "timeout" and 0 < n < 40
    stats = ranks[0]["faults"]["stats"]
    assert stats["cancellations"] >= 1 and stats["timeouts"] == 1
    # the follower aborted the same request for the same reason
    assert ranks[1]["faults"]["keep"]["e"] == "timeout"


def test_idle_gap_keeps_the_followers_waiting(served):
    ranks = served["worlds"][2]
    res = ranks[0]["faults"]["leader"]
    assert res["idle_heartbeats"] >= 2
    assert ranks[1]["faults"]["follow"]["heartbeats"] >= 2


def test_hard_reset_after_a_hang_on_rank0(served):
    ranks = served["worlds"][2]
    res = ranks[0]["faults"]["leader"]
    st, fin = res["hang"]
    assert st == 200 and fin.get("done") and "error" in fin
    assert res["rebuilt"]
    # the reset engine serves as a fresh one, on every rank
    st, toks, fin = res["late"]
    assert (toks, fin["logprobs"]) == tuple(ranks[0]["fresh"]["g"])
    assert ranks[1]["faults"]["keep"]["g"] == toks
    assert ranks[1]["fresh"]["g"] == ranks[0]["fresh"]["g"]


def test_spilled_span_restores_on_every_rank(served):
    ranks = served["worlds"][2]
    got = ranks[0]["spill"]["leader"]
    for rid in ("A", "X", "Y", "Z", "W", "A2"):
        assert got[rid][0] == 200 and got[rid][2]["finish_reason"] == "stop"
    # restored from each rank's arena: the unspilled run, bit for bit
    assert got["A2"][1] == got["A"][1]
    assert got["A2"][2]["logprobs"] == got["A"][2]["logprobs"]
    for r in ranks:
        st = r["spill"]["stats"]
        assert st["spill_spans"] > 0 and st["spill_restores"] == 1
    assert ranks[1]["spill"]["keep"]["A2"] == got["A"][1]


def test_drain_migration_cancels_on_every_rank(served):
    ranks = served["worlds"][2]
    st, toks, fin = ranks[0]["spill"]["leader"]["m"]
    assert st == 200 and fin["finish_reason"] == "migrated"
    assert 3 <= len(fin["tokens"]) < 40 and fin["tokens"][:len(toks)] == toks
    assert fin["resume_kv"] == ""     # a tp replica's spans stay its own
    assert ranks[1]["spill"]["stats"]["cancellations"] == \
        ranks[0]["spill"]["stats"]["cancellations"] == 1


# -------------------------------------------------------------- the fleet
def test_follower_sigkill_fails_over_bitwise(served):
    """Every stream completes; the failed-over greedy ones are the
    direct tp engine's resume of their committed prefix, the others the
    direct engine's uninterrupted streams."""
    ref = served["ref"]
    committed = _committed(served["fe_ring"])
    moved = 0
    for r in served["fleet_reqs"]:
        rid = r["request_id"]
        st, toks, fin = served["fleet"][rid]
        assert st == 200 and fin["finish_reason"] == "stop", (rid, fin)
        assert toks == fin["tokens"] and len(toks) == 48, rid
        c = committed.get(rid, 0)
        if "temperature" in r and c:
            continue          # a sampled failover re-derives its seed
        want = ref["resumed"][f"{rid}@{c}"] if c else ref["ref"][rid]
        assert (toks, fin["logprobs"]) == tuple(want), (rid, c)
        moved += c > 0
    assert moved >= 1, committed
    assert served["fe_health"]["peer_failovers"] >= 1


def test_killed_replica_ends_within_the_watchdog_and_grace(served):
    """Rank 0 finds the loss and exits with ``EXIT_RANK_LOST``; the
    launcher ends with the first non-zero code it polls (the follower's
    -9 or rank 0's 70) and stops every other rank."""
    kill = served["kill"]
    assert kill["rc"] in (EXIT_RANK_LOST, 256 - signal.SIGKILL)
    assert "lost a rank" in kill["log"]
    assert kill["gone"] and kill["gone_s"] < WATCHDOG_S + DRAIN_GRACE_S


def test_process_manager_tp2_spawns_and_kills_the_whole_group(served):
    side = served["side"]
    assert len(side["pids"]) == 2 and side["launcher"] not in side["pids"]
    assert side["gone"] and side["gone_s"] < 10


def test_sigterm_drains_a_tp_replica_and_every_rank_exits_zero(served):
    # the launcher exits 0 only when every rank did
    assert served["survivor_rc"] == 0


def test_loadgen_fleet_at_tp2(served):
    rc, out, err = served["loadgen"]
    assert rc == 0, err[-3000:]
    line = next(ln for ln in out.splitlines()
                if ln.startswith("LOADGEN_JSON "))
    rung = json.loads(line[len("LOADGEN_JSON "):])
    assert rung["completed"] == 6 and rung["fleet_replicas"] == 1


# --------------------------------------------------- in this process (tp 1)
def test_loadgen_in_process_refuses_tp():
    with pytest.raises(ValueError, match="in-process gateway serves at tp 1"):
        loadgen.main(["--tp", "2", "--device", "cpu", "--requests", "1"])


TINY_GEO = dict(max_slots=2, num_blocks=32, block_size=8,
                max_blocks_per_seq=8, prefill_buckets=(16,),
                chunk_prefill_tokens=8, enable_prefix_cache=True)


def _tiny():
    return ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu",
                                generator=ptt.make_generator(2, "cpu"))


def test_tp1_sequenced_gateway_is_the_plain_engine_bit_for_bit():
    """At tp 1 (the card's path) the batch is encoded, decoded and
    applied with no collective: the streams are the plain engine's."""
    model = _tiny()
    reqs = [dict(request_id=f"q{i}", prompt=list(range(1 + i, 20 + i)),
                 max_new_tokens=6) for i in range(3)]
    reqs.append(dict(request_id="qs", prompt=list(range(5, 15)),
                     max_new_tokens=6, temperature=0.9, seed=4))
    seq = SequencedEngine(PagedEngine(model, **TINY_GEO))

    async def run():
        gw = Gateway(seq, name="tp1-seq")
        await gw.start()
        try:
            return await asyncio.gather(*[sse(gw.port, r) for r in reqs])
        finally:
            await gw.drain()
    got = asyncio.run(run())
    direct = PagedEngine(model, **TINY_GEO)
    for r in reqs:
        direct.submit(r["request_id"], np.asarray(r["prompt"]),
                      **{k: v for k, v in r.items()
                         if k not in ("request_id", "prompt")})
    want = direct.run()
    for r, (st, _, toks, fin) in zip(reqs, got):
        rid = r["request_id"]
        assert st == 200 and toks == want[rid], rid
        assert fin["logprobs"] == direct.logprobs[rid], rid
    stats = seq.sequencer_stats()
    assert stats["stopped"] and stats["steps"] > 0
    assert stats["batch_bytes"] > 0
    assert set(stats["host_us_per_step"]) == {"record", "broadcast",
                                              "apply"}


def test_tp1_sequenced_submit_checks_before_recording():
    """A bad submit raises on rank 0 and is never recorded; the queue
    bound counts the submits not applied yet."""
    eng = PagedEngine(_tiny(), max_queue=2, **TINY_GEO)
    seq = SequencedEngine(eng)
    with pytest.raises(ValueError, match="max_new_tokens"):
        seq.submit("bad", [1, 2, 3], max_new_tokens=0)
    with pytest.raises(ValueError, match="repetition_penalty"):
        seq.submit("bad", [1, 2, 3], repetition_penalty=0)
    with pytest.raises(ValueError):
        seq.submit("bad", [1, 2, 3], temperature="hot")
    assert seq.queue == [] and eng.queue == []
    seq.submit("x", [1, 2, 3], max_new_tokens=2)
    seq.submit("y", [1, 2, 3], max_new_tokens=2)
    assert len(seq.queue) == 2 and eng.queue == []
    with pytest.raises(BackpressureError):
        seq.submit("z", [1, 2, 3], max_new_tokens=2)
    assert eng.stats["rejected"] == 1
    assert seq.cancel("y") and not seq.cancel("nope")
    out = seq.run()
    assert set(out) == {"x"} and "y" not in eng.cancelled
    seq.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        seq.submit("w", [1, 2, 3])


def test_gateway_refuses_a_bare_tp_engine_and_a_follower(monkeypatch):
    from paddle_tpu_torch.serving.gateway import check_single_rank
    eng = PagedEngine(_tiny(), **TINY_GEO)
    monkeypatch.setattr(eng, "_tp", 2, raising=False)
    with pytest.raises(NotImplementedError, match="no sequencer"):
        check_single_rank(eng, "Gateway")
    seq = SequencedEngine(PagedEngine(_tiny(), **TINY_GEO))
    check_single_rank(seq, "Gateway")
    seq.leader = False
    with pytest.raises(ValueError, match="follower"):
        check_single_rank(seq, "Gateway")
    with pytest.raises(RuntimeError, match="follow"):
        seq.submit("x", [1, 2])


def test_launcher_takes_a_module_and_passes_sigterm_on(tmp_path):
    """``launch -m module``: every rank runs the module; a SIGTERM to the
    launcher reaches them, and the job ends with their codes (0)."""
    mod = tmp_path / "tp_launch_probe.py"
    mod.write_text(
        "import os, signal, sys, time\n"
        "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
        "open(os.path.join(sys.argv[1], 'r' + os.environ['RANK']), 'w')"
        ".write(' '.join(sys.argv[2:]))\n"
        "time.sleep(60)\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}:{tmp_path}")
    p = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc", "2", "--cpu", "--grace", "20", "-m", "tp_launch_probe",
         str(tmp_path), "--tp", "2"], env=env, cwd=ROOT)
    deadline = time.monotonic() + 60
    while not all((tmp_path / f"r{r}").exists() for r in range(2)):
        assert time.monotonic() < deadline and p.poll() is None
        time.sleep(0.05)
    p.send_signal(signal.SIGTERM)
    assert p.wait(30) == 0
    assert (tmp_path / "r1").read_text() == "--tp 2"


def test_a_lost_rank_ends_the_replica():
    """At tp > 1 a batch that raises (a peer's connection reset) or a
    step the watchdog finds stuck inside a batch ends the replica through
    ``on_lost``; nothing is retried on it. (A tp 1 sequencer with its
    degree forced up: the batch still goes through encode and decode.)"""
    import time as _time
    lost = []
    eng = PagedEngine(_tiny(), **TINY_GEO)
    seq = SequencedEngine(eng, on_lost=lost.append)
    seq.tp = 2

    def broken():
        raise RuntimeError("Connection reset by peer")
    eng.step = broken
    seq.submit("x", [1, 2, 3], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="lost a rank"):
        seq.step()
    assert lost and "Connection reset" in lost[0]
    with pytest.raises(RuntimeError, match="lost a rank"):
        seq.hard_reset()              # no rebuild in place
    # the watchdog's hook: stuck inside a batch ends it, outside not
    lost.clear()
    seq2 = SequencedEngine(PagedEngine(_tiny(), **TINY_GEO),
                           on_lost=lost.append)
    seq2.tp = 2
    seq2.check_lost(1.0)
    assert not lost
    seq2._in_flush = _time.monotonic()
    with pytest.raises(RuntimeError, match="stuck"):
        seq2.check_lost(31.0)
    assert lost and "stuck for 31.0 s" in lost[0]


def test_watchdog_ends_a_replica_stuck_inside_a_sequenced_step():
    lost = []
    eng = PagedEngine(_tiny(), **TINY_GEO)
    seq = SequencedEngine(eng, on_lost=lost.append)
    seq.tp = 2
    real_step = eng.step

    def slow():
        time.sleep(1.5)
        return real_step()
    eng.step = slow

    async def run():
        gw = Gateway(seq, name="tp-stuck", watchdog_timeout_s=0.3,
                     breaker_backoff_s=60.0)
        gw._workers[0].warmed = True
        await gw.start()
        try:
            task = asyncio.ensure_future(sse(gw.port, dict(
                prompt=list(range(1, 10)), max_new_tokens=4)))
            deadline = time.monotonic() + 10
            while not lost and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            task.cancel()
        finally:
            seq.lost = None          # let the drain finish here
            seq._stopped = True
            await gw.drain()
    asyncio.run(run())
    assert lost and "stuck" in lost[0]
