"""The port's fleet-scale chaos simulator
(``paddle_tpu_torch/serving/fleet/sim.py``) on the CPU: the default-tier
cases of ``tests/test_fleet_sim.py`` on the port's real control plane
(frontend, router, autoscaler, burn engine, breakers), and the JAX
``FleetSim`` against the port's, for every name in ``SCENARIOS`` at a
small replica count, with the same seed: the same summary document
(requests, routing verdicts, pages and their scoring, scale events,
probe rounds, HA and transfer ledgers, gossip counters), exactly. The
two 1000-replica runs stay ``slow`` as in the JAX file. Also the port's
``python -m paddle_tpu_torch.serving.fleet.sim`` CLI: ``--check`` passes
and a run writes no file unless asked.
"""
import importlib.util
import json
import os

import pytest

from paddle_tpu.serving.fleet import build_scenario as jax_build
from paddle_tpu.utils import faults as jax_faults

from paddle_tpu_torch.serving.fleet import (SCENARIOS, FleetSim,
                                            build_scenario)
from paddle_tpu_torch.serving.fleet.sim import (arrivals_from_reqtrace,
                                                arrivals_from_series)
from paddle_tpu_torch.serving.fleet.sim import main as sim_main
from paddle_tpu_torch.utils import faults
from paddle_tpu_torch.utils.observability import validate_series_doc

SMALL = dict(n_replicas=12, duration_s=60.0, base_rate=8.0, seed=1)


def _run(name, **kw):
    """Build + run one scenario with the fault registry clean on both
    sides (storm/partition arm real fault sites process-globally)."""
    faults.reset()
    try:
        sim = build_scenario(name, **{**SMALL, **kw})
        res = sim.run()
        return sim, res
    finally:
        faults.reset()


def _load_tool(name):
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ============================================================ real objects
def test_sim_clean_runs_real_objects_no_pages():
    """The incident-free twin: every request completes, nothing is
    shed, and the burn engine raises no page — on the REAL control
    plane (identity-asserted, not duck-typed lookalikes)."""
    sim, res = _run("clean")
    objs = res["real_objects"]
    assert objs["frontend"] \
        == "paddle_tpu_torch.serving.fleet.frontend.FleetFrontend"
    assert objs["router"] \
        == "paddle_tpu_torch.serving.router.PrefixAffinityRouter"
    assert objs["burn_engine"] == "paddle_tpu_torch.serving.slo.BurnRateEngine"
    assert objs["probe_schedule"] \
        == "paddle_tpu_torch.serving.fleet.remote.probe_delay"
    assert res["requests"] > 0
    assert res["completed"] == res["requests"]
    assert res["shed"] == 0 and res["no_replica"] == 0
    assert res["alerts"]["page_fires"] == 0
    assert res["alerts"]["false_pages"] == 0
    # the router actually routed (warm/sticky ladder engaged)
    assert res["decisions_total"] >= res["requests"]
    assert res["verdicts"].get("warm", 0) > 0


def test_sim_same_seed_is_deterministic():
    _, a = _run("clean")
    _, b = _run("clean")
    for key in ("requests", "completed", "shed", "decisions_total",
                "verdicts"):
        assert a[key] == b[key]
    assert a["probe"]["rounds"] == b["probe"]["rounds"]


# ================================================================= chaos
def test_sim_outage_pages_and_freezes_autoscaler():
    """Correlated outage: the page fires inside the incident window
    (recall 1.0), the clean twin stays silent (precision 1.0), and
    the autoscaler FREEZES instead of scaling down on the survivors'
    artifact-idle aggregate — then thaws on recovery."""
    sim, res = _run("outage", n_replicas=16, duration_s=80.0)
    al = res["alerts"]
    assert al["incidents_paged_expected"] == 1
    assert al["incidents_detected"] == 1, al
    assert al["false_pages"] == 0, al
    assert al["precision"] == 1.0 and al["recall"] == 1.0
    sc = res["scale"]
    assert sc["freezes"] >= 1
    assert sc["downs"] == 0          # the freeze held the floor
    actions = [e["action"] for e in sc["events"]]
    assert "thaw" in actions[actions.index("freeze"):]
    assert not sc["frozen"]          # recovered by sim end


def test_sim_storm_probe_overload_pages():
    """Probe storm (jitter collapsed through the REAL ``peer_storm``
    fault site): the synchronized herd overflows the per-bin probe
    budget, probes time out, dispatch latency absorbs the frontend
    pressure — and the page fires with a silent clean twin."""
    sim, res = _run("storm", n_replicas=16, duration_s=80.0)
    al = res["alerts"]
    assert al["incidents_detected"] == 1 and al["false_pages"] == 0
    assert res["probe"]["timeouts"] > 0      # the mechanism, not luck
    assert res["probe"]["deferred"] > 0


def test_sim_partition_degrades_gossip_without_paging():
    """A gossip partition is NOT a page: links record partitioned
    rounds, sticky/digest adoption stalls, but the data plane holds
    (no false page — the precision half of the alert contract)."""
    sim, res = _run("partition", n_frontends=2)
    assert res["alerts"]["page_fires"] == 0
    assert res["alerts"]["false_pages"] == 0
    gossip = res["gossip"]
    assert len(gossip) == 2                  # full mesh, both ways
    assert sum(g["partitioned"] for g in gossip) > 0
    assert sum(g["rounds"] for g in gossip) > 0


# ==================================================================== HA
def test_sim_ha_frontend_kill_loses_no_committed_tokens():
    """The leaderless-failover pin, in-sim: killing a frontend
    mid-stream severs its in-flight requests; every severed stream is
    either resumed on the survivor or synthesized (fully committed),
    and the committed-token ledger balances exactly — zero lost, zero
    duplicated, zero corrupted."""
    sim, res = _run("ha", n_frontends=2)
    ha = res["ha"]
    assert ha["severed_streams"] >= 1
    assert ha["severed_streams"] \
        == ha["resumed_streams"] + ha["synthesized_streams"]
    assert ha["corrupted_streams"] == 0
    assert ha["tokens_lost"] == 0
    assert ha["tokens_duplicated"] == 0
    assert ha["committed_tokens_preserved"] > 0
    assert res["alerts"]["false_pages"] == 0
    # the dead frontend stopped serving; the survivor carried the rest
    assert sim.fe_alive.count(True) == 1
    assert res["completed"] == res["requests"] - res["shed"] \
        - res["no_replica"]


# ============================================================ trace replay
def test_sim_replay_round_trip_series(tmp_path):
    """Arrivals recovered from a sim's own dumped series doc drive a
    second sim: the replayed offered load matches the recorded one to
    sampling granularity (the last partial bin may shave the tail)."""
    sim, res = _run("clean")
    p = str(tmp_path / "series.json")
    sim.dump_series(p)
    with open(p) as f:
        doc = json.load(f)
    arrivals = arrivals_from_series(doc,
                                    metric="fleet_requests_total")
    assert 0.8 * res["requests"] <= len(arrivals) <= res["requests"]
    faults.reset()
    try:
        sim2 = FleetSim(n_replicas=12, seed=2,
                        duration_s=arrivals[-1] + 1.0,
                        arrival_times=arrivals)
        res2 = sim2.run()
    finally:
        faults.reset()
    assert res2["requests"] == len(arrivals)
    assert res2["completed"] == res2["requests"]


def test_arrivals_from_reqtrace_shift_and_scale():
    doc = {"entries": [{"wall_accept": 100.0},
                       {"wall_accept": 104.0},
                       {"wall_accept": 102.0},
                       {"wall_accept": None}]}
    assert arrivals_from_reqtrace(doc) == [0.0, 2.0, 4.0]
    assert arrivals_from_reqtrace(doc, scale=2.0) == [0.0, 1.0, 2.0]
    with pytest.raises(ValueError):
        arrivals_from_reqtrace({"entries": []})


def test_arrivals_from_series_requires_metric():
    with pytest.raises(ValueError):
        arrivals_from_series({"metrics": {}})


# ================================================================== dumps
def test_sim_dumps_validate_and_render_through_fleet_dash(tmp_path):
    """The sim's dumps are standard documents: the series doc passes
    the shared validator and the UNMODIFIED fleet_dash loads both
    files from a dump dir and puts the injected incident, the page
    and the autoscaler freeze on one timeline."""
    sim, res = _run("outage", n_replicas=16, duration_s=80.0)
    sim.dump_series(str(tmp_path / "sim_outage_s1_series.json"))
    sim.dump_flight(str(tmp_path / "sim_outage_s1_flight.json"))
    with open(tmp_path / "sim_outage_s1_series.json") as f:
        doc = json.load(f)
    assert validate_series_doc(doc) == []
    dash = _load_tool("fleet_dash")
    docs, flights = dash.load_docs([str(tmp_path)])
    assert len(docs) == 1 and len(flights) == 1
    events = dash.collect_events(docs, flights)
    kinds = {e["kind"] for e in events}
    assert "incident_start" in kinds and "incident_end" in kinds
    assert "alert_fire" in kinds
    assert any(k.startswith("scale_freeze") for k in kinds)
    text = dash.render(docs, events)
    assert "req/s" in text           # frontend-level fleet_* rows
    assert "# incident" in text      # the marker legend
    assert "incident_start" in text


def test_scenario_registry_is_closed():
    assert set(SCENARIOS) == {"clean", "outage", "storm", "partition",
                              "brownout", "brownout_spill", "diurnal",
                              "ha", "drain_migrate", "drain_reprefill"}
    with pytest.raises(ValueError):
        build_scenario("nope")


# ======================================================= 1000-stub scale
@pytest.mark.slow
def test_sim_thousand_replica_storm_acceptance():
    """The acceptance rung at full scale: 1000 SimReplicas,
    a probe storm, the page fires with zero false pages, and the run
    stays under the 60s CPU budget (a routing decision is O(n) in
    fleet size, so the throughput floor here is coarse)."""
    faults.reset()
    try:
        sim = build_scenario("storm", n_replicas=1000,
                             duration_s=120.0, base_rate=40.0, seed=1)
        res = sim.run()
    finally:
        faults.reset()
    assert res["cpu_s"] < 60.0, res["cpu_s"]
    al = res["alerts"]
    assert al["incidents_detected"] == 1 and al["false_pages"] == 0
    assert res["decisions_per_sec"] > 100.0
    assert res["probe"]["timeouts"] > 0


@pytest.mark.slow
def test_sim_thousand_replica_ha_kill():
    """Leaderless failover at 1000 stubs: the severed-stream ledger
    still balances exactly at fleet scale."""
    faults.reset()
    try:
        sim = build_scenario("ha", n_replicas=1000, n_frontends=2,
                             duration_s=120.0, base_rate=40.0, seed=1)
        res = sim.run()
    finally:
        faults.reset()
    assert res["cpu_s"] < 60.0, res["cpu_s"]
    ha = res["ha"]
    assert ha["severed_streams"] >= 1
    assert ha["tokens_lost"] == 0 and ha["tokens_duplicated"] == 0
    assert ha["corrupted_streams"] == 0
    assert res["alerts"]["false_pages"] == 0


# ============================================ against the JAX package
# what a run measures on the host clock, and nothing else
CLOCKED = ("cpu_s", "decisions_per_sec")


def _summary(res):
    out = {k: v for k, v in res.items() if k not in CLOCKED}
    out["real_objects"] = {
        k: v.replace("paddle_tpu_torch.", "paddle_tpu.", 1)
        for k, v in res["real_objects"].items()}
    return out


@pytest.mark.parametrize("name", SCENARIOS)
def test_sim_summary_matches_jax(name):
    kw = dict(SMALL, n_frontends=2 if name in ("ha", "partition") else 1)
    _, got = _run(name, **kw)
    jax_faults.reset()
    try:
        ref = jax_build(name, **kw).run()
    finally:
        jax_faults.reset()
    assert _summary(got) == _summary(ref)
    assert got["requests"] > 0


def test_sim_cli_check_and_no_rung_by_default(tmp_path, capsys):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = set(os.listdir(root))
    assert sim_main(["--check"]) == 0
    assert sim_main(["--scenario", "clean", "--replicas", "8",
                     "--duration", "30", "--rate", "4"]) == 0
    assert set(os.listdir(root)) == before
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("SIM_JSON "))
    assert json.loads(line[len("SIM_JSON "):])["scenario"] == "clean"
    rung = str(tmp_path / "rung.json")
    assert sim_main(["--scenario", "clean", "--replicas", "8",
                     "--duration", "30", "--rate", "4",
                     "--out", rung]) == 0
    with open(rung) as f:
        doc = json.load(f)
    assert doc["device"] == "cpu"
    assert doc["fleet_sim"]["scenarios"] == ["clean"]
